"""Hand-written CUDA kernels of the port, one package per kernel: the C
source under ``csrc/``, the plain PyTorch version in ``ref.py`` and the
wrapper in ``ops.py``. ``_build.py`` builds and binds them."""
