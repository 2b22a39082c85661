"""File input and output of the port."""
