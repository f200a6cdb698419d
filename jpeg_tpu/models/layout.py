"""MCU geometry: scan-order permutations and layout math.

Replaces the reference's per-block coordinate mapping (`blockToCoords`,
src/preprocess.c:199-211) with precomputed index permutations shared by the
encoder (raster -> scan gather) and decoder (scan -> raster scatter).
"""

from __future__ import annotations

import functools

import numpy as np


def ceil_div(a: int, b: int) -> int:
    return -(-a // b)


@functools.lru_cache(maxsize=256)
def mcu_scan_permutation(mcu_rows: int, mcu_cols: int, v: int, h: int) -> np.ndarray:
    """Permutation p with scan_blocks = raster_blocks[p].

    A component with sampling (h, v) contributes an (mcu_rows*v, mcu_cols*h)
    raster grid of blocks; within each MCU its blocks appear in v-by-h raster
    order (spec A.2.3). Returns (mcu_rows*mcu_cols*v*h,) raster indices in scan
    order.
    """
    i = np.arange(mcu_rows)[:, None, None, None]
    j = np.arange(mcu_cols)[None, :, None, None]
    a = np.arange(v)[None, None, :, None]
    b = np.arange(h)[None, None, None, :]
    raster = (i * v + a) * (mcu_cols * h) + (j * h + b)
    return raster.reshape(-1).astype(np.int64)


@functools.lru_cache(maxsize=256)
def inverse_permutation(mcu_rows: int, mcu_cols: int, v: int, h: int) -> np.ndarray:
    return np.argsort(mcu_scan_permutation(mcu_rows, mcu_cols, v, h))


def scan_to_raster(blocks, mcu_rows: int, mcu_cols: int, v: int, h: int):
    """Scan-order (mcu_rows*mcu_cols*v*h, ...) component blocks -> plane
    raster block order, as a reshape+transpose (works on NumPy and JAX arrays
    alike; equals blocks[inverse_permutation(...)] without the gather — row
    gathers cost real memory traffic, a transpose is pure layout)."""
    lead = blocks.shape[1:]
    x = blocks.reshape(mcu_rows, mcu_cols, v, h, *lead)
    x = x.transpose(0, 2, 1, 3, *range(4, 4 + len(lead)))
    return x.reshape(mcu_rows * mcu_cols * v * h, *lead)
