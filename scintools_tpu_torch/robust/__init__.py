"""robust layer of the PyTorch/CUDA port."""
