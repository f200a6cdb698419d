"""Forward/inverse 8x8 DCT-II as batched matmuls against a fixed basis.

Matmul replacement for the reference's naive O(64^2)-with-cos()-in-the-loop
per-block DCT (`src/dct.c:36-59`, measured ~97% of its runtime — SURVEY.md §6).
Here the transform is `D @ X @ D^T` with an 8x8 orthonormal basis precomputed on
host, so the whole image becomes two dense tensor contractions that XLA tiles
onto matrix units; there is no per-block code at all. The IDCT is the exact transpose
pair (`D^T @ C @ D`) — the decoder stage the reference never wrote
(`src/headers/jpg_decode.h` is empty).

Two layouts are supported:
  * block layout (..., 8, 8) — einsum over the trailing dims;
  * image layout (H, W) — separable transform with large free dims (H and W) so
    the contraction runs against wide matrices instead of 8-wide ones.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

# A default-precision f32 matmul may round its inputs (bf16 passes, or TF32 on
# a GPU's tensor cores); JPEG quantization is decided by coefficient values, so
# the DCT runs at HIGHEST, full float32 products on every backend.
_PRECISION = jax.lax.Precision.HIGHEST


@functools.cache
def dct_basis() -> np.ndarray:
    """Orthonormal 8x8 DCT-II basis D: coeffs = D @ x for a length-8 signal.

    D[u, x] = c(u)/2 * cos((2x+1) u pi / 16), c(0) = 1/sqrt(2), else 1.
    Satisfies D @ D.T = I, so the inverse transform is D.T.
    """
    u = np.arange(8)[:, None].astype(np.float64)
    x = np.arange(8)[None, :].astype(np.float64)
    d = 0.5 * np.cos((2.0 * x + 1.0) * u * np.pi / 16.0)
    d[0, :] *= 1.0 / np.sqrt(2.0)
    return d.astype(np.float32)


@functools.cache
def idct_scaled_basis(k: int) -> np.ndarray:
    """(k, 8) basis B for DCT-domain 8->k downscaling: a k x k spatial block
    from the top-left k x k of an 8-point coefficient block via
    out = B @ C @ B^T (libjpeg jidctred semantics, exact float form).

    B[y, u] = sqrt(k/8) * Tk[u, y] for u < k (Tk = orthonormal k-point DCT),
    zero otherwise; the sqrt(k/8) rescale makes a constant block decode to its
    own value (spectral truncation preserves the mean). k = 8 reduces to the
    full IDCT transpose."""
    if k not in (1, 2, 4, 8):
        raise ValueError(f"scaled IDCT supports k in 1/2/4/8, got {k}")
    u = np.arange(k)[:, None].astype(np.float64)
    y = np.arange(k)[None, :].astype(np.float64)
    t = np.sqrt(2.0 / k) * np.cos((2.0 * y + 1.0) * u * np.pi / (2.0 * k))
    t[0, :] *= 1.0 / np.sqrt(2.0)
    b = np.zeros((k, 8), dtype=np.float64)
    b[:, :k] = np.sqrt(k / 8.0) * t.T
    return b.astype(np.float32)


def fdct_blocks(blocks: jnp.ndarray) -> jnp.ndarray:
    """(..., 8, 8) spatial blocks -> (..., 8, 8) DCT coefficients."""
    d = jnp.asarray(dct_basis())
    # D @ X @ D^T, batched over leading dims.
    return jnp.einsum(
        "uy,...yx,vx->...uv", d, blocks.astype(jnp.float32), d,
        preferred_element_type=jnp.float32, precision=_PRECISION,
    )


def idct_blocks(coeffs: jnp.ndarray) -> jnp.ndarray:
    """(..., 8, 8) DCT coefficients -> (..., 8, 8) spatial blocks."""
    d = jnp.asarray(dct_basis())
    # X = D^T @ C @ D: contract the frequency axes of D against C.
    return jnp.einsum(
        "uy,...uv,vx->...yx", d, coeffs.astype(jnp.float32), d,
        preferred_element_type=jnp.float32, precision=_PRECISION,
    )


@functools.cache
def zigzag_dct_matrix() -> np.ndarray:
    """(64, 64) matrix M with zz_coeffs = M @ block_flat: the full 2-D DCT
    (kron(D, D) over a row-major flattened 8x8 block) with the zig-zag
    permutation folded into the row order.

    The hot-path form: ONE contraction replaces the two separable einsums
    PLUS the zig-zag gather. M is orthogonal (permutation x orthogonal kron), so the
    inverse transform is M^T — see idct_zigzag_blocks.
    """
    from jpeg_tpu import tables

    d = dct_basis().astype(np.float64)
    k = np.kron(d, d)
    return k[np.asarray(tables.ZIGZAG_ORDER)].astype(np.float32)


def fdct_zigzag_blocks(flat_blocks: jnp.ndarray) -> jnp.ndarray:
    """(B, 64) row-major flattened spatial blocks -> (B, 64) zig-zag-ordered
    DCT coefficients, one HIGHEST-precision contraction."""
    m = jnp.asarray(zigzag_dct_matrix())
    return jax.lax.dot_general(
        flat_blocks.astype(jnp.float32), m, (((1,), (1,)), ((), ())),
        precision=_PRECISION, preferred_element_type=jnp.float32,
    )


def idct_zigzag_blocks(zz: jnp.ndarray) -> jnp.ndarray:
    """(B, 64) zig-zag-ordered (dequantized) coefficients -> (B, 64) row-major
    flattened spatial blocks (the exact transpose pair of fdct_zigzag_blocks)."""
    m = jnp.asarray(zigzag_dct_matrix())
    return jax.lax.dot_general(
        zz.astype(jnp.float32), m, (((1,), (0,)), ((), ())),
        precision=_PRECISION, preferred_element_type=jnp.float32,
    )


def fdct_plane(plane: jnp.ndarray) -> jnp.ndarray:
    """Separable DCT over an (H, W) plane kept in image layout.

    Output stays in image layout: coefficient (u, v) of block (a, b) lives at
    pixel (8a+u, 8b+v). Both contractions have a free dim of W or H (>=128 for
    real images), which maps far better onto matrix units than 8-wide
    per-block matmuls.
    """
    h, w = plane.shape
    assert h % 8 == 0 and w % 8 == 0
    d = jnp.asarray(dct_basis())
    x = plane.astype(jnp.float32)
    # Vertical pass: contract within-block row index.
    v = jnp.einsum("uy,ayw->auw", d, x.reshape(h // 8, 8, w),
                   preferred_element_type=jnp.float32, precision=_PRECISION).reshape(h, w)
    # Horizontal pass: contract within-block column index.
    out = jnp.einsum("ahx,vx->ahv", v.reshape(h, w // 8, 8), d,
                     preferred_element_type=jnp.float32, precision=_PRECISION).reshape(h, w)
    return out


def idct_plane(coeffs: jnp.ndarray) -> jnp.ndarray:
    """Inverse of fdct_plane (image-layout separable IDCT)."""
    h, w = coeffs.shape
    assert h % 8 == 0 and w % 8 == 0
    d = jnp.asarray(dct_basis())
    c = coeffs.astype(jnp.float32)
    v = jnp.einsum("uy,auw->ayw", d, c.reshape(h // 8, 8, w),
                   preferred_element_type=jnp.float32, precision=_PRECISION).reshape(h, w)
    out = jnp.einsum("ahv,vx->ahx", v.reshape(h, w // 8, 8), d,
                     preferred_element_type=jnp.float32, precision=_PRECISION).reshape(h, w)
    return out
