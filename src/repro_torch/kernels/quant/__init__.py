from repro_torch.kernels.quant.ops import dequantize, quantize

__all__ = ["dequantize", "quantize"]
