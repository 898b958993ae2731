"""Hand-written Hopper kernels of the port.

Each kernel directory holds ``csrc/*.cu`` (CUDA C++ for sm_90a with a plain
C entry point, built by :mod:`repro_torch.kernels._build`), ``ref.py`` (the
plain PyTorch version) and ``ops.py`` (the wrapper: the plain version for
CPU tensors, the kernel for CUDA tensors, and a launch counter).
"""
