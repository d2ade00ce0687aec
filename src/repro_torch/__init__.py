"""PyTorch/CUDA port of the CQ-GGADMM reproduction (``src/repro`` is the JAX
reference). The port keeps the JAX package's module names and places; its
hot kernels are CUDA C++ for Hopper under ``kernels/csrc``. Entry points run
on the CUDA device unless the caller asks for ``device="cpu"``."""
