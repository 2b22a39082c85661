"""ops layer of the PyTorch/CUDA port."""
