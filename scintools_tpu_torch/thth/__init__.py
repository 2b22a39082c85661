"""thth layer of the PyTorch/CUDA port."""
