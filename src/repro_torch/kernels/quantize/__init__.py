"""int8 block quantize / dequantize (``repro/kernels/quantize``): CUDA
kernels (kernel.py), plain versions (ref.py) and the public API (ops.py)."""
from repro_torch.kernels.quantize.ops import (dequantize_blocks, dequantize_sum_blocks,
                                              dequantize_sum_quantize_blocks,
                                              quantize_blocks)

__all__ = ["dequantize_blocks", "dequantize_sum_blocks", "dequantize_sum_quantize_blocks",
           "quantize_blocks"]
