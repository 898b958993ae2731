from repro_torch.kernels.reduce_add.ops import add_accum

__all__ = ["add_accum"]
