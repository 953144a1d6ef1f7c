"""YT-8M uint8 feature (de)quantization.

Reference semantics (utils.py :: Dequantize):
    Dequantize(x, max_quantized_value=2, min_quantized_value=-2)
      = x * (max - min) / 255  + min
and the inverse used when the dataset was produced:
    quantize(x) = round((clip(x, min, max) - min) * 255 / (max - min))

Works on numpy arrays and torch tensors alike (pure arithmetic), so the
same function is the host-side oracle and the on-device dequantize. The
uint8 -> float conversion runs on the device: features cross PCIe as
uint8, a quarter of the float32 bytes.
"""

from __future__ import annotations

import numpy as np


# The affine constants for the default (-2, 2) range, for kernels that
# fold dequantization into another per-dim affine.
DEQUANT_SCALE = 4.0 / 255.0
DEQUANT_BIAS = 4.0 / 512.0 - 2.0


def dequantize(feat, max_quantized_value=2.0, min_quantized_value=-2.0):
    """uint8 (or float holding 0..255) -> float in [min, max]."""
    quantized_range = max_quantized_value - min_quantized_value
    scalar = quantized_range / 255.0
    bias = (quantized_range / 512.0) + min_quantized_value
    # Reference formula is feat * scalar + min; the starter actually uses
    # `feat * scalar + bias` in utils.Dequantize (bias centers each bucket).
    return feat * scalar + bias


def quantize(feat, max_quantized_value=2.0, min_quantized_value=-2.0):
    """float -> uint8, inverse of :func:`dequantize` (fixture generation)."""
    feat = np.clip(feat, min_quantized_value, max_quantized_value)
    quantized_range = max_quantized_value - min_quantized_value
    x = (feat - min_quantized_value) * (255.0 / quantized_range)
    return np.round(x).astype(np.uint8)
