"""Hand-written Hopper kernels of the port.

Each kernel directory holds ``csrc/*.cu`` (CUDA C++ for sm_90a with a plain
C entry point, built by :mod:`repro_torch.kernels._build`), ``ref.py`` (the
plain PyTorch version) and ``ops.py`` (the wrapper: the plain version for
CPU tensors, the kernel for CUDA tensors, and a launch counter).
"""

import threading

# one lock for every wrapper's launch counters: the rails of a communicator
# launch from host threads of their own (repro_torch.comm.rails), and a lost
# ``+= 1`` would miscount a path's launches
LAUNCH_LOCK = threading.Lock()
