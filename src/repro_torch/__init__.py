"""repro_torch: the PyTorch + CUDA port of :mod:`repro`.

The package mirrors ``repro``'s module paths (``repro_torch.serve.engine`` is
the port of ``repro.serve.engine``) and imports nothing of it, JAX included.
Entry points run on ``cuda`` unless the caller passes ``device="cpu"``; every
hand-written kernel has a plain PyTorch version beside it, which runs only
for tensors that lie on the CPU.
"""
