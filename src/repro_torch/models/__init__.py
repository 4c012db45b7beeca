"""Serving forward of the dense transformer family, in PyTorch."""
