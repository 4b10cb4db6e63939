"""Hand-written CUDA kernels for Hopper (``sm_90a``), each beside a plain
PyTorch version of the same function.  Sources live in ``../csrc``; they
are compiled with ``nvcc`` at first use (:mod:`._build`) and bound with
``ctypes``."""
