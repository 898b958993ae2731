from repro_torch.kernels.flash_decode.ops import (flash_decode,
                                                 flash_decode_stats)
from repro_torch.kernels.flash_decode.ref import combine

__all__ = ["flash_decode", "flash_decode_stats", "combine"]
