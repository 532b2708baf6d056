"""Hand-written CUDA kernels for Hopper (sources in ``../csrc``), their
plain PyTorch versions (``ref.py``) and the public wrappers (``ops.py``).

Kernels build at first use (``_build.py``); importing this package builds
and launches nothing.
"""
