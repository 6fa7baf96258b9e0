"""Hand-written CUDA kernels of the parse path, their launchers, wrappers
(``ops.py``) and plain PyTorch versions (``ref.py``)."""
