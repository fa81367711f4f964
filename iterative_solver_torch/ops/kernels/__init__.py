"""Hand-written CUDA C++ kernels of the port (``csrc/``), each beside its
plain PyTorch version. Importing these modules builds nothing: a kernel is
built with ``nvcc`` at its first launch (``_build.py``)."""
