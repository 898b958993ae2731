from repro_torch.kernels.flash_attn.ops import flash_attention

__all__ = ["flash_attention"]
