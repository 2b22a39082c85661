"""fit layer of the PyTorch/CUDA port."""
