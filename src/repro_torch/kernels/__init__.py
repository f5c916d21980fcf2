"""Hand-written Hopper kernels (``csrc/``), their ``ctypes`` bindings, the
plain PyTorch versions (``ref.py``) and the public wrappers (``ops.py``)."""
