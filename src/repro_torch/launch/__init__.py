"""Command-line drivers of the PyTorch/CUDA port."""
