"""Pairwise-kernel ops: dispatch (``ops``), plain PyTorch versions
(``ref``) and the CUDA kernel wrappers."""
