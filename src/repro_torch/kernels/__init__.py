"""Hand-written Hopper kernels (``csrc/*.cu``), their ctypes bindings and
their plain PyTorch versions (``ref.py``)."""
