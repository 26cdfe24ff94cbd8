"""Post-training quantization and quantized serving (port of
``repro/quant``: ``ptq`` per-leaf host path, ``serve.qmatmul``)."""
from .ptq import (DEFAULT_SKIP, compression_ratio, dequantize_tree,
                  quantize_tree, should_quantize)
from .serve import fallback_count, qmatmul

__all__ = ["DEFAULT_SKIP", "compression_ratio", "dequantize_tree",
           "fallback_count", "qmatmul", "quantize_tree", "should_quantize"]
