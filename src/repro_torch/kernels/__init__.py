"""Hand-written CUDA kernels of the port, one package each, each with its
plain PyTorch version beside it (``ref.py``; AdamW's is
``optim.adamw.adamw_update_plain``) and a launch count on its wrapper
(``ops.py``)."""
