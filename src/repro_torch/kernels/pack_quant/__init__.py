from repro_torch.kernels.pack_quant.ops import (read_dequant_flat,
                                               write_quant_flat)

__all__ = ["read_dequant_flat", "write_quant_flat"]
