"""Hand-written CUDA kernels of the port (csrc/*.cu) and their plain
PyTorch versions (ref.py)."""
