from repro_torch.kernels.block_quant.ops import dequantize, quantize

__all__ = ["quantize", "dequantize"]
