"""Hand-written CUDA kernels of the parse path and the LM serving path, their
launchers, wrappers (``ops.py``) and plain PyTorch versions (``ref.py``)."""
