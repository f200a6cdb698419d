"""Device-side JPEG symbol statistics (static shapes, jit/shard-friendly).

The vectorized replacement for the reference's serial per-block frequency
accumulation (`calculate_freq_block_DC/AC`, src/huffman.c:182-222): every
(run, size) symbol count is derived with vectorized array ops — zero-run
lengths via an exclusive cumulative max over nonzero positions — and reduced
with scatter-adds. Under shard_map the histograms are combined with psum,
which is exactly the distributed version of huffman.c:29-42's global
accumulation (SURVEY.md §5 "Distributed communication backend").
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def bit_size(v: jnp.ndarray) -> jnp.ndarray:
    """JPEG magnitude category (0..11) as a jnp op: bits in |v|.

    floor(log2(mag))+1 read straight from the f32 exponent field (exact: the
    int->f32 convert is lossless below 2^24 and coefficients fit 16 bits).
    Pure bit ops — cheaper than the log2 transcendental they replace."""
    mag = jnp.abs(v).astype(jnp.int32)
    f = mag.astype(jnp.float32)
    exp = (jax.lax.bitcast_convert_type(f, jnp.int32) >> 23) - 126
    return jnp.where(mag > 0, exp, 0)


def ac_run_lengths(zz: jnp.ndarray):
    """Per-coefficient zero-run info for (..., 64) zig-zag blocks.

    Returns (nz, run, last_nz):
      nz[..., k]    bool, k in 1..63 position is nonzero (position 0 forced False)
      run[..., k]   zeros between this nonzero and the previous one
      last_nz[...]  index of last nonzero AC position (0 if none)
    """
    idx = jnp.arange(64, dtype=jnp.int32)
    nz = (zz != 0) & (idx > 0)
    markers = jnp.where(nz, idx, 0)
    cmax = jax.lax.cummax(markers, axis=markers.ndim - 1)
    prev = jnp.concatenate(
        [jnp.zeros_like(cmax[..., :1]), cmax[..., :-1]], axis=-1
    )
    run = idx - prev - 1
    last_nz = cmax[..., -1]
    return nz, run, last_nz


def symbol_histogram(zz: jnp.ndarray):
    """(N, 64) zig-zag blocks (DC element already DPCM'd) -> (dc_hist, ac_hist).

    Both histograms are (256,) int32 symbol counts for one table class; callers
    pass luma and chroma blocks separately and psum across shards.
    """
    zz = zz.astype(jnp.int32)
    # DC: one size-class symbol per block.
    dsize = bit_size(zz[:, 0])
    dc_hist = jnp.zeros(256, jnp.int32).at[dsize].add(1)

    nz, run, last_nz = ac_run_lengths(zz)
    size = bit_size(zz)
    sym = ((run % 16) << 4) | size
    # Real (run, size) symbols: weight 1 where nonzero.
    ac_hist = jnp.zeros(256, jnp.int32).at[jnp.where(nz, sym, 0)].add(
        nz.astype(jnp.int32)
    )
    # ZRL (0xF0): run // 16 emissions per nonzero.
    zrl_counts = jnp.where(nz, run >> 4, 0).sum()
    ac_hist = ac_hist.at[0xF0].add(zrl_counts.astype(jnp.int32))
    # EOB (0x00): blocks whose last nonzero is before position 63.
    ac_hist = ac_hist.at[0x00].add(jnp.sum(last_nz < 63).astype(jnp.int32))
    return dc_hist, ac_hist


def bits_per_block(zz: jnp.ndarray, dc_len_lut: jnp.ndarray, ac_len_lut: jnp.ndarray):
    """Exact entropy-coded bit count per block for one table class.

    dc_len_lut/ac_len_lut: (256,) Huffman code lengths. Used for on-device
    bitstream size planning (prefix-sum stitch) and rate estimation.
    """
    zz = zz.astype(jnp.int32)
    dsize = bit_size(zz[:, 0])
    bits = dc_len_lut[dsize] + dsize

    nz, run, last_nz = ac_run_lengths(zz)
    size = bit_size(zz)
    sym = ((run % 16) << 4) | size
    per_coef = jnp.where(nz, ac_len_lut[sym] + size + (run >> 4) * ac_len_lut[0xF0], 0)
    bits = bits + per_coef.sum(axis=-1)
    bits = bits + jnp.where(last_nz < 63, ac_len_lut[0x00], 0)
    return bits
