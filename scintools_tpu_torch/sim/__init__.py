"""sim layer of the PyTorch/CUDA port."""
