"""Hand-written CUDA kernels of the port, one package each, each with its
plain PyTorch version beside it (``ref.py``) and a launch count on its
wrapper (``ops.py``)."""
