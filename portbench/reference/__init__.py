"""Plain references of what the program computes (PyTorch and NumPy;
nothing of the program is imported here)."""
