"""RGB <-> YCbCr (BT.601 full-range, JFIF) as fusable matmuls.

Vectorized replacement for the reference's per-pixel scalar loop
(`src/preprocess.c:155-169`). Fixes the Cb sign bug at `preprocess.c:161`
(the reference computes 128 - (0.168736 R - 0.331264 G + 0.5 B)). Also unlike
the reference (`src/preprocess.c:176-196`), the -128 level shift is applied to
the *luma path only as part of the DCT stage*, not baked in here — chroma is
already centered by the +128 offset, and keeping this op a pure color-space
map makes it reusable by the decoder.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

# Full f32 matmul precision: a default-precision f32 matmul may round its
# inputs (bf16 passes, or TF32 on a GPU's tensor cores), which would perturb
# pixel-level color conversion (see ops/dct.py for the same rationale).
_PRECISION = jax.lax.Precision.HIGHEST

# y/cb/cr = RGB_TO_YCBCR @ [r, g, b] + [0, 128, 128]
RGB_TO_YCBCR = np.array(
    [
        [0.299, 0.587, 0.114],
        [-0.168735892, -0.331264108, 0.5],
        [0.5, -0.418687589, -0.081312411],
    ],
    dtype=np.float32,
)
YCBCR_OFFSET = np.array([0.0, 128.0, 128.0], dtype=np.float32)

# Inverse map: [r, g, b] = YCBCR_TO_RGB @ [y, cb - 128, cr - 128]
YCBCR_TO_RGB = np.array(
    [
        [1.0, 0.0, 1.402],
        [1.0, -0.344136286, -0.714136286],
        [1.0, 1.772, 0.0],
    ],
    dtype=np.float32,
)


def rgb_to_ycbcr(rgb: jnp.ndarray) -> jnp.ndarray:
    """(..., 3) float/uint8 RGB in [0,255] -> (..., 3) float32 YCbCr in [0,255].

    Implemented as a (..., 3) x (3, 3) contraction so XLA fuses it into adjacent
    elementwise work and can feed a matrix unit for large images.
    """
    x = rgb.astype(jnp.float32)
    m = jnp.asarray(RGB_TO_YCBCR.T)
    return jnp.matmul(x, m, precision=_PRECISION) + jnp.asarray(YCBCR_OFFSET)


def rgb_to_ycbcr_planes(rgb: jnp.ndarray):
    """(H, W, 3) RGB in [0,255] -> three (H, W) float32 planes (y, cb, cr).

    Elementwise FMA form of rgb_to_ycbcr: with only 3 output channels a
    matmul wastes most of a matrix unit's width; the FMA chain fuses into
    adjacent elementwise work. Same coefficients; float32 rounding may differ
    from the matmul form in the last ulp.
    """
    x = rgb.astype(jnp.float32)
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    y = 0.299 * r + 0.587 * g + 0.114 * b
    cb = -0.168735892 * r - 0.331264108 * g + 0.5 * b + 128.0
    cr = 0.5 * r - 0.418687589 * g - 0.081312411 * b + 128.0
    return y, cb, cr


def cmyk_to_rgb(cmyk) -> np.ndarray:
    """(..., 4) uint8 CMYK (PIL-mode samples, as decode() returns for Adobe
    4-component streams) -> (..., 3) uint8 RGB, bit-exact with PIL's
    Image.convert("RGB"): channel = round((255-C) * (255-K) / 255).

    Host-side NumPy: this runs on decoded pixels (CLI output paths), not in
    the jitted pipeline."""
    a = np.asarray(cmyk).astype(np.int32)
    if a.shape[-1] != 4:
        raise ValueError(f"expected (..., 4) CMYK, got {a.shape}")
    inv = 255 - a
    rgb = (inv[..., :3] * inv[..., 3:4] + 127) // 255
    return rgb.astype(np.uint8)


def ycbcr_to_rgb(ycc: jnp.ndarray, clip: bool = True) -> jnp.ndarray:
    """(..., 3) YCbCr in [0,255] -> (..., 3) float32 RGB, optionally clipped."""
    x = ycc.astype(jnp.float32) - jnp.asarray(YCBCR_OFFSET)
    m = jnp.asarray(YCBCR_TO_RGB.T)
    out = jnp.matmul(x, m, precision=_PRECISION)
    if clip:
        out = jnp.clip(out, 0.0, 255.0)
    return out
