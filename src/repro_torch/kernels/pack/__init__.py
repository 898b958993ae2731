from repro_torch.kernels.pack.ops import read_flat, write_flat

__all__ = ["read_flat", "write_flat"]
