"""Seeded photographic-like test images.

Tests, benchmarks and the GPU smoke check need content whose entropy-coded
statistics resemble a photograph — smooth shading, textures at every scale,
hard object edges, sensor noise, correlated color channels — without shipping
image files. `photo` builds one from a seed with NumPy alone: fractal value
noise (bilinearly upsampled random grids, amplitude falling with frequency),
a few hard-edged ellipses, and mild Gaussian noise.
"""

from __future__ import annotations

import numpy as np

TEXTURE = 30.0


def _interp_matrix(n: int, cells: int) -> np.ndarray:
    """(n, cells + 1) bilinear weights sampling a cells-wide grid at n points."""
    pos = np.linspace(0.0, cells, n, dtype=np.float64)
    lo = np.minimum(pos.astype(np.int64), cells - 1)
    frac = (pos - lo).astype(np.float32)
    m = np.zeros((n, cells + 1), dtype=np.float32)
    m[np.arange(n), lo] = 1.0 - frac
    m[np.arange(n), lo + 1] = frac
    return m


def _fractal(rng, h: int, w: int, channels: int, octaves) -> np.ndarray:
    """(channels, h, w) float32 value noise: sum over (cells, amplitude)
    octaves of upsampled uniform random grids."""
    out = np.zeros((channels, h, w), dtype=np.float32)
    aspect = w / h
    for cells, amp in octaves:
        ch = max(1, int(cells))
        cw = max(1, int(round(cells * aspect)))
        wr = _interp_matrix(h, ch)
        wc = _interp_matrix(w, cw)
        grid = rng.uniform(-1.0, 1.0, (channels, ch + 1, cw + 1)).astype(
            np.float32)
        for c in range(channels):
            out[c] += amp * (wr @ grid[c] @ wc.T)
    return out


def photo(h: int, w: int, seed: int = 0, gray: bool = False) -> np.ndarray:
    """(h, w, 3) uint8 — or (h, w) when gray — photographic-like image,
    a pure function of (h, w, seed). Detail scales with the frame: the
    coarsest octave spans the image and the finest reaches ~2-pixel
    features, as in a photograph at any resolution."""
    if h <= 0 or w <= 0:
        raise ValueError(f"bad image size {h}x{w}")
    rng = np.random.default_rng(seed)
    octaves = []
    cells = 2.0
    while cells <= h / 2:
        octaves.append((cells, 60.0 * (2.0 / cells) ** 0.55))
        cells *= 2.0
    lum = 120.0 + _fractal(rng, h, w, 1, octaves)[0]
    chroma = _fractal(rng, h, w, 2, octaves[:4]) * 0.6
    # Textured regions (foliage, fur, fabric): fine-scale noise gated by a
    # smooth mask, the content that sets a JPEG's densest blocks.
    mask = np.clip(_fractal(rng, h, w, 1, [(2.0, 1.0), (4.0, 0.5)])[0] * 2.0,
                   0.0, 1.0)
    fine = _fractal(rng, h, w, 1, [(h / 8, 0.5), (h / 4, 0.8), (h / 2, 1.0)])
    lum = lum + TEXTURE * mask * fine[0]

    # Hard-edged objects: ellipses with their own flat shade and texture.
    yy = np.arange(h, dtype=np.float32)[:, None]
    xx = np.arange(w, dtype=np.float32)[None, :]
    for _ in range(6):
        cy, cx = rng.uniform(0, h), rng.uniform(0, w)
        ry = rng.uniform(0.05, 0.35) * h
        rx = rng.uniform(0.05, 0.35) * w
        inside = ((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 <= 1.0
        lum = np.where(inside, lum + rng.uniform(-70, 70), lum)
        shade = rng.uniform(-25, 25, 2).astype(np.float32)
        chroma = np.where(inside[None], chroma + shade[:, None, None], chroma)

    lum = lum + rng.normal(0.0, 2.0, (h, w)).astype(np.float32)
    if gray:
        return np.clip(np.rint(lum), 0, 255).astype(np.uint8)
    cb, cr = chroma[0], chroma[1]
    rgb = np.stack([lum + 1.402 * cr,
                    lum - 0.344136 * cb - 0.714136 * cr,
                    lum + 1.772 * cb], axis=-1)
    return np.clip(np.rint(rgb), 0, 255).astype(np.uint8)
