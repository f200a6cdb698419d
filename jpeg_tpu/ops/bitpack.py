"""Device-side parallel Huffman bit packing (the SURVEY.md §7 step-6 crux).

Entirely data-parallel XLA, with NO scatter and NO data-dependent gather
anywhere: every Huffman record (code +
amplitude bits) becomes a <=32-bit field; per-channel prefix sums give
in-block bit offsets; channels emit into per-block word buffers by a masked
lane reduce (level 1, `_level1_channels`); block buffers shift-combine into
per-MCU buffers (level 1.5); and the stream assembles by a log-depth
pairwise shift-OR concatenation tree (level 2, `concat_bitstreams_tree`,
which replaced a sorted segment-sum scatter). Only the compressed words
leave the device — for a 4K frame that shrinks the download from ~50 MB of
coefficients to the ~0.5 MB scan itself.

All arithmetic is 32-bit (x64 stays disabled). Record channels per block:

  [DC | (zrl_pair, zrl_single, code+amp) x 63 | EOB]  ->  191 records

ZRL runs (up to 3 ZRL symbols before a coefficient) are split so no record
exceeds 32 bits: a pair of ZRLs (<=32 bits since code length <=16) plus a
single. Byte stuffing, restart markers and final 1-padding stay on the host
(they touch only the compressed bytes).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from jpeg_tpu.entropy.huffman import HuffTable
from jpeg_tpu.ops import symbols


def luts_from_tables(huff: dict):
    """{(is_ac, id): HuffTable} -> (dc_code, dc_len, ac_code, ac_len) stacked
    (2, 256) arrays (uint32 / int32)."""
    dc_code = np.zeros((2, 256), dtype=np.uint32)
    dc_len = np.zeros((2, 256), dtype=np.int32)
    ac_code = np.zeros((2, 256), dtype=np.uint32)
    ac_len = np.zeros((2, 256), dtype=np.int32)
    for (is_ac, tid), t in huff.items():
        if tid > 1:
            raise ValueError("device packer supports table ids 0/1")
        if is_ac:
            ac_code[tid] = t.code.astype(np.uint32)
            ac_len[tid] = t.size.astype(np.int32)
        else:
            dc_code[tid] = t.code.astype(np.uint32)
            dc_len[tid] = t.size.astype(np.int32)
    return dc_code, dc_len, ac_code, ac_len


def _amp_bits(v, size):
    """JPEG amplitude field in uint32 (one's-complement style negatives)."""
    amp = jnp.where(v >= 0, v, v + (1 << size) - 1)
    return amp.astype(jnp.uint32) & ((jnp.uint32(1) << size.astype(jnp.uint32)) - 1)


def _onehot_lookup(flat, table_cols, width):
    """Small-table Huffman lookup as a one-hot dot: flat (B, n) int32
    indices, table_cols (width, 3) f32 [code_hi, code_lo, len] -> (code
    uint32, len int32).

    Exact on every backend: both operands are bfloat16, which holds the
    one-hot 0/1 entries and every table column (<= 255, hence the hi/lo
    byte split of the codes) exactly, so no backend has a lower-precision
    multiply to fall to (an f32 dot at DEFAULT precision may run as bf16
    passes or TF32); each output is a single exact product accumulated in
    float32."""
    oh = jax.nn.one_hot(flat, width, dtype=jnp.bfloat16)
    res = jax.lax.dot_general(
        oh, table_cols.astype(jnp.bfloat16),
        (((flat.ndim,), (0,)), ((), ())),
        preferred_element_type=jnp.float32,
    )
    code = (res[..., 0].astype(jnp.int32) << 8) | res[..., 1].astype(jnp.int32)
    return code.astype(jnp.uint32), res[..., 2].astype(jnp.int32)


def _split_cols(code, length):
    """(k,) uint32 codes + int lens -> (k, 3) f32 [hi, lo, len] columns."""
    return jnp.stack(
        [
            (code >> 8).astype(jnp.float32),
            (code & 255).astype(jnp.float32),
            length.astype(jnp.float32),
        ],
        axis=1,
    )


def build_bitfields(blocks, tbl, dc_code, dc_len, ac_code, ac_len):
    """(B, 64) int32 zig-zag blocks (DC = DPCM diff), (B,) table ids ->
    (bits (B, 191) uint32, nbits (B, 191) int32) in emission order."""
    blocks = blocks.astype(jnp.int32)
    tbl = tbl.astype(jnp.int32)

    # DC: sizes are 0..15, so a 32-wide one-hot (tbl*16 + size) suffices.
    dc = blocks[:, 0]
    dsize = symbols.bit_size(dc)
    dc_tab = _split_cols(dc_code[:, :16].reshape(32),
                         dc_len[:, :16].reshape(32))
    dcode, dlen = _onehot_lookup(tbl * 16 + dsize, dc_tab, 32)
    dbits = (dcode << dsize.astype(jnp.uint32)) | _amp_bits(dc, dsize)
    dnbits = dlen + dsize

    # AC: two-stage lookup. A one-shot 512-wide one-hot would materialize a
    # (B, 63, 512) f32 LHS (~25 GB of memory traffic on 4K). Stage 1
    # one-hots only (tbl, run) — 32 wide — into 16 size-candidates per
    # element via one dot; stage 2 selects by size elementwise (fuses).
    # Values code*32+len <= 2^21 are exact in f32 and HIGHEST precision
    # (full float32 products, never bf16 or TF32 passes) keeps the dot exact.
    nz, run, last_nz = symbols.ac_run_lengths(blocks)
    nz = nz[:, 1:]
    run = jnp.where(nz, run[:, 1:], 0)
    v = blocks[:, 1:]
    size = jnp.where(nz, symbols.bit_size(v), 0)
    t1 = (ac_code.astype(jnp.float32) * 32.0
          + ac_len.astype(jnp.float32)).reshape(32, 16)  # [(tbl, run), size]
    oh = jax.nn.one_hot(tbl[:, None] * 16 + (run & 15), 32, dtype=jnp.float32)
    cand = jax.lax.dot_general(
        oh, t1, (((2,), (0,)), ((), ())),
        precision=jax.lax.Precision.HIGHEST,
        preferred_element_type=jnp.float32,
    )
    sel = jnp.sum(cand * jax.nn.one_hot(size, 16, dtype=jnp.float32), axis=-1)
    packed = sel.astype(jnp.int32)
    code = (packed >> 5).astype(jnp.uint32)
    aclen = packed & 31
    clen = jnp.where(nz, aclen, 0)
    cbits = jnp.where(
        nz, (code << size.astype(jnp.uint32)) | _amp_bits(v, size), 0
    )
    cn = clen + size

    # ZRL / EOB codes: two possible values each (one per table id) — selects,
    # not gathers.
    is1 = tbl[:, None] == 1
    zc = jnp.where(is1, ac_code[1, 0xF0], ac_code[0, 0xF0])
    zl = jnp.where(is1, ac_len[1, 0xF0], ac_len[0, 0xF0])
    kz = jnp.where(nz, run >> 4, 0)  # 0..3
    pair = (zc << zl.astype(jnp.uint32)) | zc
    n0 = jnp.minimum(kz, 2) * zl
    b0 = jnp.where(kz >= 2, pair, jnp.where(kz == 1, zc, 0))
    n1 = jnp.maximum(kz - 2, 0) * zl
    b1 = jnp.where(kz >= 3, zc, 0)

    # EOB
    eob = last_nz < 63
    e1 = tbl == 1
    ebits = jnp.where(eob, jnp.where(e1, ac_code[1, 0], ac_code[0, 0]), 0)
    enbits = jnp.where(eob, jnp.where(e1, ac_len[1, 0], ac_len[0, 0]), 0)

    ac_bits = jnp.stack([b0, b1, cbits], axis=-1).reshape(blocks.shape[0], 189)
    ac_nbits = jnp.stack([n0, n1, cn], axis=-1).reshape(blocks.shape[0], 189)
    bits = jnp.concatenate(
        [dbits[:, None], ac_bits, ebits[:, None]], axis=1
    )
    nbits = jnp.concatenate(
        [dnbits[:, None], ac_nbits, enbits[:, None]], axis=1
    )
    return bits, nbits


# Per-block bit budget for the device packer. A block whose entropy-coded size
# exceeds this makes the device report failure (ok=False) and the encoder
# falls back to the host packer — correctness never depends on the cap.
# 9 words = 288 bits; typical q<=90 blocks need 30-150 bits.
BLOCK_WORDS = 9


def _emit_channel(bits, nbits, starts, block_words: int):
    """Level-1 word-buffer contribution of one record channel: (B, n)
    fields at in-block bit offsets `starts` -> (B, block_words+1) uint32
    (the masked-reduce emission, per channel)."""
    hi, lo = _field_split(bits, nbits, starts)
    w_r = jnp.clip(starts >> 5, 0, block_words - 1)
    wg = jnp.arange(block_words + 1, dtype=jnp.int32)[None, None, :]
    return jnp.sum(
        jnp.where(w_r[:, :, None] == wg, hi[:, :, None], jnp.uint32(0))
        + jnp.where((w_r + 1)[:, :, None] == wg, lo[:, :, None],
                    jnp.uint32(0)),
        axis=1,
        dtype=jnp.uint32,
    )


def _level1_channels(blocks, tbl, dc_code, dc_len, ac_code, ac_len,
                     block_words: int = BLOCK_WORDS):
    """Fused field build + level 1: (B, 64) zig-zag blocks -> per-block
    ((B, block_words+1) uint32 buffers, (B,) int32 bit totals) WITHOUT
    materializing the interleaved 191-field record stream (build_bitfields'
    (B, 191) bits/nbits plus their stack intermediates). Channel start
    offsets come from ONE cumsum over per-position totals; each channel
    emits into the word buffer independently. Lookups are bf16 one-hot dots
    against byte-plane-split tables — 0/1 x <=255 products with f32
    accumulation are exact, at half the one-hot traffic of the f32 HIGHEST
    form. Byte-identical to build_bitfields + _level1_mask."""
    from jpeg_tpu.ops import symbols

    blocks = blocks.astype(jnp.int32)
    tbl = tbl.astype(jnp.int32)
    nb = blocks.shape[0]

    def dot_planes(oh, table_int):
        """one-hot (B, n, K) bf16 x (K, M) int table (<= 2^24) -> exact
        (B, n, M) int32 via three byte-plane DEFAULT dots."""
        acc = None
        for shift in (16, 8, 0):
            plane = ((table_int >> shift) & 255).astype(jnp.bfloat16)
            p = jax.lax.dot_general(
                oh, plane, (((oh.ndim - 1,), (0,)), ((), ())),
                preferred_element_type=jnp.float32,
            ).astype(jnp.int32)
            acc = p if acc is None else (acc << 8) + p
        return acc

    # DC: 32-wide one-hot over (tbl, size).
    dc = blocks[:, 0]
    dsize = symbols.bit_size(dc)
    dc_t = (dc_code[:, :16].astype(jnp.int32) * 32
            + dc_len[:, :16].astype(jnp.int32)).reshape(32, 1)
    oh_dc = jax.nn.one_hot(tbl * 16 + dsize, 32, dtype=jnp.bfloat16)
    dcp = dot_planes(oh_dc[:, None, :], dc_t)[:, 0, 0]
    dcode = jax.lax.shift_right_logical(dcp, 5).astype(jnp.uint32)
    dlen = dcp & 31
    dbits = (dcode << dsize.astype(jnp.uint32)) | _amp_bits(dc, dsize)
    dnbits = dlen + dsize

    # AC stage 1: 32-wide one-hot over (tbl, run) -> 16 size candidates.
    nz, run, last_nz = symbols.ac_run_lengths(blocks)
    nz = nz[:, 1:]
    run = jnp.where(nz, run[:, 1:], 0)
    v = blocks[:, 1:]
    size = jnp.where(nz, symbols.bit_size(v), 0)
    ac_t1 = (ac_code.astype(jnp.int32) * 32
             + ac_len.astype(jnp.int32)).reshape(32, 16)
    oh = jax.nn.one_hot(tbl[:, None] * 16 + (run & 15), 32,
                        dtype=jnp.bfloat16)
    cand = dot_planes(oh, ac_t1)  # (B, 63, 16) int32
    # AC stage 2: elementwise select by size.
    sel = jnp.sum(
        cand * jax.nn.one_hot(size, 16, dtype=jnp.int32), axis=-1
    )
    code = jax.lax.shift_right_logical(sel, 5).astype(jnp.uint32)
    aclen = sel & 31
    clen = jnp.where(nz, aclen, 0)
    cbits = jnp.where(
        nz, (code << size.astype(jnp.uint32)) | _amp_bits(v, size), 0
    )
    cn = clen + size

    # ZRL / EOB: two possible values each — selects.
    is1 = tbl[:, None] == 1
    zc = jnp.where(is1, ac_code[1, 0xF0], ac_code[0, 0xF0])
    zl = jnp.where(is1, ac_len[1, 0xF0], ac_len[0, 0xF0])
    kz = jnp.where(nz, run >> 4, 0)
    pair = (zc << zl.astype(jnp.uint32)) | zc
    n0 = jnp.minimum(kz, 2) * zl
    b0 = jnp.where(kz >= 2, pair, jnp.where(kz == 1, zc, 0))
    n1 = jnp.maximum(kz - 2, 0) * zl
    b1 = jnp.where(kz >= 3, zc, 0)
    eob = last_nz < 63
    e1 = tbl == 1
    ebits = jnp.where(eob, jnp.where(e1, ac_code[1, 0], ac_code[0, 0]), 0)
    enbits = jnp.where(eob, jnp.where(e1, ac_len[1, 0], ac_len[0, 0]), 0)

    return _emit_record_channels(dbits, dnbits, b0, n0, b1, n1, cbits, cn,
                                 ebits, enbits, block_words)


def _emit_record_channels(dbits, dnbits, b0, n0, b1, n1, cbits, cn,
                          ebits, enbits, block_words: int):
    """Shared channel-wise emission: per-channel start offsets from ONE
    cumsum over per-position totals (emission order per position:
    b0 -> b1 -> code; then EOB), then the masked-reduce emission per
    channel. Returns ((B, block_words+1) uint32 buffers, (B,) totals)."""
    nb = dbits.shape[0]
    t_slot = n0 + n1 + cn
    p_incl = jnp.cumsum(t_slot, axis=1)
    s0 = dnbits[:, None] + (p_incl - t_slot)
    s1 = s0 + n0
    s2 = s1 + n1
    se = dnbits[:, None] + p_incl[:, -1:]
    t_b = se[:, 0] + enbits

    buf = (
        _emit_channel(dbits[:, None], dnbits[:, None],
                      jnp.zeros((nb, 1), jnp.int32), block_words)
        + _emit_channel(b0, n0, s0, block_words)
        + _emit_channel(b1, n1, s1, block_words)
        + _emit_channel(cbits, cn, s2, block_words)
        + _emit_channel(ebits[:, None], enbits[:, None], se, block_words)
    )
    return buf, t_b


def _level1_channels_fixed(blocks, tid: int, dc_code, dc_len, ac_code,
                           ac_len, block_words: int = BLOCK_WORDS,
                           lookup: str = "tree"):
    """Channel-wise level 1 for blocks that ALL share one STATIC Huffman
    table id (the encoder's MCU interleave is a static [0]*hv + [1, 1]
    pattern per MCU, so Y and C split into contiguous fixed-id arrays —
    see _level1_channels_split). Versus the mixed-id `_level1_channels`:

      * the AC code lookup needs no table-id axis (it is compile-time), so
        the dominant lookup traffic halves;
      * ZRL/EOB codes become scalars (no (B, 63) table-id selects).

    lookup — the (run, size) -> code*32+len map, all bit-identical:
      "tree" (default): elementwise binary select tree over the 256-entry
        table — 255 fused selects per coefficient, no one-hot LHS and no
        (B, 63, 16) candidate tensor at all;
      "bf16": 16-wide one-hot dots against 8-bit byte planes (exact by the
        0/1 x <=255 f32-accumulation argument), size-select folded into
        each plane dot's consumer;
      "int8": 7-bit planes in s8 x s8 -> s32 dots;
      "stack": the bf16 planes stacked to one (16, 48) RHS (the wider
        candidate tensor materializes).

    Byte-identical to _level1_channels with tbl filled with `tid`."""
    from jpeg_tpu.ops import symbols

    blocks = blocks.astype(jnp.int32)

    if lookup in ("bf16", "stack", "tree"):
        oh_dtype, pbits, shifts = jnp.bfloat16, 8, (16, 8, 0)
    elif lookup == "int8":
        oh_dtype, pbits, shifts = jnp.int8, 7, (14, 7, 0)
    else:
        raise ValueError(f"unknown lookup variant: {lookup!r}")
    pmask = (1 << pbits) - 1

    # DC: 16 packed values selected by size — a one-hot weighted sum
    # (elementwise int32, (B, 16) fuses away; no matmul needed at B x 16).
    dc = blocks[:, 0]
    dsize = symbols.bit_size(dc)
    dc_t = (dc_code[tid, :16].astype(jnp.int32) * 32
            + dc_len[tid, :16].astype(jnp.int32))  # (16,)
    dcp = jnp.sum(
        jax.nn.one_hot(dsize, 16, dtype=jnp.int32) * dc_t[None, :], axis=-1
    )
    dcode = jax.lax.shift_right_logical(dcp, 5).astype(jnp.uint32)
    dlen = dcp & 31
    dbits = (dcode << dsize.astype(jnp.uint32)) | _amp_bits(dc, dsize)
    dnbits = dlen + dsize

    # AC code lookup over (run, size).
    nz, run, last_nz = symbols.ac_run_lengths(blocks)
    nz = nz[:, 1:]
    run = jnp.where(nz, run[:, 1:], 0)
    v = blocks[:, 1:]
    size = jnp.where(nz, symbols.bit_size(v), 0)
    ac_t = (ac_code[tid].astype(jnp.int32) * 32
            + ac_len[tid].astype(jnp.int32)).reshape(16, 16)  # [run, size]
    if lookup == "tree":
        # Binary select tree over the flat 256-entry table: one fused
        # elementwise pass over (B, 63); selects are exact integer ops.
        flat_t = ac_t.reshape(256)
        idx = (run & 15) * 16 + size
        vals = [flat_t[j] for j in range(256)]
        bit = 1
        while len(vals) > 1:
            pick = (idx & bit) != 0
            vals = [jnp.where(pick, vals[2 * j + 1], vals[2 * j])
                    for j in range(len(vals) // 2)]
            bit <<= 1
        sel = vals[0]
    elif lookup == "stack":
        # One dot against the three byte planes stacked to (16, 48): the
        # one-hot LHS is read ONCE instead of once per plane, but the
        # (B, 63, 48) candidate tensor materializes.
        oh = jax.nn.one_hot(run & 15, 16, dtype=oh_dtype)
        oh_sz = jax.nn.one_hot(size, 16, dtype=jnp.float32)
        planes = jnp.concatenate(
            [((ac_t >> s) & pmask).astype(oh_dtype) for s in shifts],
            axis=1)                                           # (16, 48)
        p = jax.lax.dot_general(
            oh, planes, (((2,), (0,)), ((), ())),
            preferred_element_type=jnp.float32,
        ).reshape(*oh.shape[:2], 3, 16)
        pp = jnp.sum(p * oh_sz[:, :, None, :], axis=-1).astype(jnp.int32)
        sel = (((pp[..., 0] << pbits) + pp[..., 1]) << pbits) + pp[..., 2]
    else:
        oh = jax.nn.one_hot(run & 15, 16, dtype=oh_dtype)     # (B, 63, 16)
        oh_sz = jax.nn.one_hot(size, 16, dtype=jnp.float32)
        sel = None
        for shift in shifts:
            plane = ((ac_t >> shift) & pmask).astype(oh_dtype)  # (16, 16)
            p = jax.lax.dot_general(
                oh, plane, (((2,), (0,)), ((), ())),
                preferred_element_type=jnp.float32 if lookup == "bf16"
                else jnp.int32,
            )
            pp = jnp.sum(
                p.astype(jnp.float32) * oh_sz, axis=-1).astype(jnp.int32)
            sel = pp if sel is None else (sel << pbits) + pp
    code = jax.lax.shift_right_logical(sel, 5).astype(jnp.uint32)
    aclen = sel & 31
    clen = jnp.where(nz, aclen, 0)
    cbits = jnp.where(
        nz, (code << size.astype(jnp.uint32)) | _amp_bits(v, size), 0
    )
    cn = clen + size

    # ZRL / EOB: scalars (the table id is static).
    zc = ac_code[tid, 0xF0]
    zl = ac_len[tid, 0xF0]
    kz = jnp.where(nz, run >> 4, 0)
    pair = (zc << zl.astype(jnp.uint32)) | zc
    n0 = jnp.minimum(kz, 2) * zl
    b0 = jnp.where(kz >= 2, pair, jnp.where(kz == 1, zc, jnp.uint32(0)))
    n1 = jnp.maximum(kz - 2, 0) * zl
    b1 = jnp.where(kz >= 3, zc, jnp.uint32(0))
    eob = last_nz < 63
    ebits = jnp.where(eob, ac_code[tid, 0], jnp.uint32(0))
    enbits = jnp.where(eob, ac_len[tid, 0], 0)

    return _emit_record_channels(dbits, dnbits, b0, n0, b1, n1, cbits, cn,
                                 ebits, enbits, block_words)


def _level1_channels_split(blocks, hv: int, dc_code, dc_len, ac_code,
                           ac_len, block_words: int = BLOCK_WORDS,
                           lookup: str = "tree"):
    """Level 1 for MCU-interleaved blocks with the encoder's STATIC
    [luma]*hv + [chroma]*2 per-MCU table pattern: slice Y and C into
    contiguous arrays (static slices — no gather), run the fixed-id level 1
    on each at half the one-hot width, and re-interleave the (B, bw+1)
    word buffers (cheap: ~2% of level-1 traffic). Byte-identical to
    _level1_channels with the equivalent tbl array."""
    bpm = hv + 2
    nm = blocks.shape[0] // bpm
    bm = blocks.reshape(nm, bpm, 64)
    yb = bm[:, :hv].reshape(nm * hv, 64)
    cb = bm[:, hv:].reshape(nm * 2, 64)
    ybuf, yt = _level1_channels_fixed(
        yb, 0, dc_code, dc_len, ac_code, ac_len, block_words, lookup)
    cbuf, ct = _level1_channels_fixed(
        cb, 1, dc_code, dc_len, ac_code, ac_len, block_words, lookup)
    w = ybuf.shape[1]
    buf = jnp.concatenate(
        [ybuf.reshape(nm, hv, w), cbuf.reshape(nm, 2, w)], axis=1
    ).reshape(nm * bpm, w)
    t_b = jnp.concatenate(
        [yt.reshape(nm, hv), ct.reshape(nm, 2)], axis=1
    ).reshape(nm * bpm)
    return buf, t_b


def _field_split(bits, nbits, starts):
    """Split each <=32-bit field into (hi, lo) word contributions given its
    start bit offset. All shifts clamped to [0, 31]: the unselected jnp.where
    branch is still evaluated and XLA shifts >= bit width are undefined."""
    sh = (starts & 31).astype(jnp.int32)
    over = jnp.maximum(sh + nbits - 32, 0)  # bits spilling into word+1
    hi = jnp.where(
        over > 0,
        bits >> over.astype(jnp.uint32),
        bits << jnp.clip(32 - sh - nbits, 0, 31).astype(jnp.uint32),
    ).astype(jnp.uint32)
    lo = jnp.where(
        over > 0, bits << jnp.clip(32 - over, 0, 31).astype(jnp.uint32), 0
    ).astype(jnp.uint32)
    return hi, lo


def _subword_shift(buf, sbits):
    """Shift each row of a (G, C) uint32 word buffer right by sbits (G, 1)
    bits (0..31), i.e. toward later stream positions within its words:
    out[j] = (buf[j] >> s) | (buf[j-1] << (32-s)). Returns (G, C+1) — the +1
    lane catches the spill out of the last word. Alias of the n-d form."""
    return _subword_shift_nd(buf, sbits)


def _tree_combine(buf, t):
    """One level of the log-depth bitstream concatenation: pairs of (C,)-word
    buffers with bit totals t become (2C,)-word buffers holding
    left ++ right. G must be even; returns ((G/2, 2C) buffers, (G/2,) totals).

    The right sibling lands at bit offset t_left: a sub-word shift by
    t_left & 31 plus a word-level barrel shift by t_left >> 5 — the barrel is
    log2(C)+1 static pad-shifts gated by jnp.where on the offset's bits, so
    the whole level is dense vector work (pads + selects + shifts), with NO
    scatter and NO data-dependent gather."""
    left, right = buf[0::2], buf[1::2]
    tl, tr = t[0::2], t[1::2]
    c = buf.shape[1]
    rs = _subword_shift(right, (tl & 31)[:, None])  # (G/2, C+1)
    rs = jnp.pad(rs, ((0, 0), (0, c - 1)))          # (G/2, 2C)
    w = (tl >> 5)[:, None]                          # word offset, 0..C
    b = 1
    while b <= c:
        shifted = jnp.pad(rs, ((0, 0), (b, 0)))[:, : 2 * c]
        rs = jnp.where((w & b) != 0, shifted, rs)
        b <<= 1
    return jnp.pad(left, ((0, 0), (0, c))) | rs, tl + tr


def concat_bitstreams_tree(buf, t, nwords: int):
    """(G, C) uint32 per-group word buffers + (G,) bit totals -> one
    (nwords,) uint32 big-endian stream by log2(G) pairwise shift-OR levels.

    This replaces the former level-2 sorted segment-sum scatter: the tree is
    pure pad/select/shift traffic (~2 x G x C words per level, log2(G)
    levels) that XLA fuses into a few passes. Bit placement is identical
    math, so streams are byte-identical to the scatter formulation (tests
    pin this).

    Capacity is exact by construction: every level doubles the per-group
    capacity, so any stream whose groups fit their buffers fits the tree.
    The result is sliced (or zero-padded) to nwords; bits beyond nwords*32
    are dropped, matching the scatter mode="drop" semantics for overflow
    streams (which set ok=False and are repacked on the host anyway)."""
    g, c = buf.shape
    t = t.astype(jnp.int32)
    total = jnp.sum(t)
    gp = 1 << max(0, (g - 1).bit_length())
    if gp != g:
        buf = jnp.pad(buf, ((0, gp - g), (0, 0)))
        t = jnp.pad(t, (0, gp - g))
    while buf.shape[0] > 1:
        buf, t = _tree_combine(buf, t)
    words = buf[0]
    if words.shape[0] < nwords:
        words = jnp.pad(words, (0, nwords - words.shape[0]))
    else:
        words = words[:nwords]
    return words, total


def _subword_shift_nd(buf, sbits):
    """_subword_shift over arbitrary leading dims: buf (..., C), sbits
    (..., 1) -> (..., C+1)."""
    zero = jnp.zeros(buf.shape[:-1] + (1,), jnp.uint32)
    ext = jnp.concatenate([buf, zero], axis=-1)
    prev = jnp.concatenate([zero, buf], axis=-1)
    su = sbits.astype(jnp.uint32)
    return (ext >> su) | jnp.where(
        sbits > 0, prev << jnp.clip(32 - sbits, 0, 31).astype(jnp.uint32), 0
    )


def _level1_tree(bits, nbits, block_words: int):
    """Per-group word buffers via a log-depth IN-BLOCK shift-OR tree: each
    <=32-bit field becomes a 1-word left-aligned buffer, then pairwise
    bitstream concatenation with the capacity clamped at block_words+1 (a
    group's content is bounded by the whole group's bit total, which the ok
    budget bounds by block_words*32; overflowing blocks produce garbage
    buffers exactly like the masked reduce — ok=False covers both).

    An alternative to level 1's (B, R, block_words+1)-lane masked reduce
    and its ~11x-per-field select traffic: the tree touches
    ~sum_l min(2^l, bw+1) * R/2^l word lanes (~2.5x less).
    Returns ((B, block_words+1) uint32 buffers, (B,) int32 totals) —
    bit-identical to the masked reduce for in-budget blocks."""
    nbits = nbits.astype(jnp.int32)
    b, r = bits.shape
    t_b = jnp.sum(nbits, axis=1)
    rp = 1 << (r - 1).bit_length()
    if rp != r:
        bits = jnp.pad(bits, ((0, 0), (0, rp - r)))
        nbits = jnp.pad(nbits, ((0, 0), (0, rp - r)))
    # Left-align each field in its own word.
    buf = jnp.where(
        nbits > 0,
        bits << jnp.clip(32 - nbits, 0, 31).astype(jnp.uint32),
        jnp.uint32(0),
    )[..., None]  # (B, rp, 1)
    t = nbits
    cap_max = block_words + 1
    while buf.shape[1] > 1:
        left, right = buf[:, 0::2], buf[:, 1::2]
        tl, tr = t[:, 0::2], t[:, 1::2]
        c = buf.shape[2]
        new_c = min(2 * c, cap_max)
        rs = _subword_shift_nd(right, (tl & 31)[..., None])  # (B, G, c+1)
        if rs.shape[2] < new_c:
            rs = jnp.pad(rs, ((0, 0), (0, 0), (0, new_c - rs.shape[2])))
        else:
            rs = rs[:, :, :new_c]
        w = (tl >> 5)[..., None]
        bshift = 1
        while bshift < new_c:
            shifted = jnp.pad(
                rs, ((0, 0), (0, 0), (bshift, 0)))[:, :, :new_c]
            rs = jnp.where((w & bshift) != 0, shifted, rs)
            bshift <<= 1
        if c < new_c:
            left = jnp.pad(left, ((0, 0), (0, 0), (0, new_c - c)))
        buf = left | rs
        t = tl + tr
    return buf[:, 0, :cap_max], t_b


def _level2_segment_sum(buf, t, nwords: int):
    """The scatter level-2 formulation, kept for A/B and the identity
    test: global bit offsets by prefix sum, sub-word shift each group buffer
    into stream alignment, then one sorted segment-sum per word lane (base is
    non-decreasing, so base+k is sorted for each k). Disjoint bit fields
    cannot carry, so int32 adds equal the uint32 OR. Out-of-range contributions are dropped (ok=False streams are repacked on
    the host, but the words stay bit-identical to scatter mode="drop")."""
    t = t.astype(jnp.int32)
    off = jnp.cumsum(t) - t
    total = off[-1] + t[-1]
    base = off >> 5
    contrib = _subword_shift(buf, (off & 31).astype(jnp.int32)[:, None])
    words = jnp.zeros(nwords, jnp.int32)
    for k in range(contrib.shape[1]):
        raw = base + k
        val = jnp.where(raw < nwords, contrib[:, k], jnp.uint32(0))
        words = words + jax.ops.segment_sum(
            jax.lax.bitcast_convert_type(val, jnp.int32),
            jnp.minimum(raw, nwords - 1),
            num_segments=nwords, indices_are_sorted=True,
        )
    return jax.lax.bitcast_convert_type(words, jnp.uint32), total


def _level2(buf, t, nwords: int, level2: str):
    if level2 == "tree_or":
        return concat_bitstreams_tree(buf, t, nwords)
    if level2 == "segment_sum":
        return _level2_segment_sum(buf, t, nwords)
    raise ValueError(f"unknown level2 formulation: {level2!r}")


def _level1_mask(bits, nbits, block_words: int):
    """Level 1 as a one-hot masked reduce of every field's
    (hi, lo) word contributions over block_words+1 lanes (the +1 lane
    catches lo spill of the last word — _emit_channel is the single home of
    that arithmetic). Kept for A/B; bit-identical to _level1_tree for
    in-budget groups."""
    nbits = nbits.astype(jnp.int32)
    starts = jnp.cumsum(nbits, axis=1) - nbits
    t_b = starts[:, -1] + nbits[:, -1]
    return _emit_channel(bits, nbits, starts, block_words), t_b


def _level1(bits, nbits, block_words: int, level1: str):
    if level1 == "tree":
        return _level1_tree(bits, nbits, block_words)
    if level1 == "mask":
        return _level1_mask(bits, nbits, block_words)
    raise ValueError(f"unknown level1 formulation: {level1!r}")


def pack_bits(bits, nbits, nwords: int, block_words: int = BLOCK_WORDS,
              level2: str = "tree_or", level1: str = "mask"):
    """Assemble (B, R) per-group <=32-bit fields into an (nwords,) uint32
    big-endian word stream. Returns (words, total_bits, ok).

    A "group" is whatever the caller reshaped a row to be: one 8x8 block
    (R = 191, block_words = 9) or one whole MCU (R = bpm*191, block_words
    sized for the MCU budget). Grouping by MCU cuts level 2's group count
    ~4x at the cost of a wider level-1 reduce.

    Two-level, scatter-free design (a 4K image has ~37M raw fields):

      1. per-block: fields -> a BLOCK_WORDS-word local buffer via a one-hot
         masked reduction over the block's fields — XLA fuses the
         (B, R, BLOCK_WORDS) broadcast into the reduction, so this is pure
         dense elementwise work;
      2. global: group buffers concatenate by the log-depth shift-OR tree
         (concat_bitstreams_tree); level2="segment_sum" keeps the sorted
         segment-sum scatter formulation for A/B.

    ok=False when any block overflowed BLOCK_WORDS*32 bits or the stream
    overflowed nwords; callers must then repack on the host.
    """
    # Level 1: per-group buffers (B, block_words+1).
    buf, t_b = _level1(bits, nbits, block_words, level1)
    # Level 2: concatenate the group buffers into the stream.
    words, total = _level2(buf, t_b, nwords, level2)
    ok = (jnp.max(t_b) <= block_words * 32) & (total <= nwords * 32)
    return words, total, ok


def pack_bits_tree(bits, nbits, nwords: int, bpm: int,
                   block_words: int = BLOCK_WORDS, mcu_words: int | None = None,
                   level2: str = "tree_or", level1: str = "mask"):
    """Three-level pack: per-BLOCK one-hot reduce (narrow), shift-combine the
    MCU's blocks into a per-MCU buffer, then the per-MCU log-depth shift-OR
    tree (concat_bitstreams_tree). Same (words, total, ok) contract as
    pack_bits.

    Motivation: grouping whole MCUs in pack_bits widens level 1's masked
    reduce to the MCU word budget over EVERY field — B*R*(bpm*4+1) lanes of
    work. Here level 1 stays block_words+1 wide (~2.5x less traffic for
    4:2:0), and the block->MCU combine touches only (bpm, block_words+2)-word
    buffers per MCU (~2% of level 1), while level 2 keeps the ~bpm x fewer
    groups of MCU grouping. ok additionally requires every block under block_words*32 bits
    (the host repack fallback covers overflow, as for pack_bits)."""
    nbits = nbits.astype(jnp.int32)
    nblocks = bits.shape[0]
    nm = nblocks // bpm
    if mcu_words is None:
        mcu_words = bpm * 4  # same MCU budget as pack_bits' "mcu" grouping

    # Level 1: per-block buffers, narrow (block_words + 1 spill lane).
    buf, t_b = _level1(bits, nbits, block_words, level1)

    mcu_buf, t_m = _combine_to_mcu(buf, t_b, bpm, block_words, mcu_words)

    # Level 2: identical to pack_bits, at MCU granularity.
    words, total = _level2(mcu_buf, t_m, nwords, level2)
    ok = (
        (jnp.max(t_b) <= block_words * 32)
        & (jnp.max(t_m) <= mcu_words * 32)
        & (total <= nwords * 32)
    )
    return words, total, ok


def _combine_to_mcu(buf, t_b, bpm: int, block_words: int, mcu_words: int):
    """Level 1.5: place each block's buffer at its bit offset inside its MCU
    -> ((nm, mcu_words+1) uint32 buffers, (nm,) bit totals)."""
    nblocks = buf.shape[0]
    nm = nblocks // bpm
    tb_m = t_b.reshape(nm, bpm)
    boff = jnp.cumsum(tb_m, axis=1) - tb_m           # (nm, bpm) bit offsets
    t_m = jnp.sum(tb_m, axis=1)                      # (nm,) bits per MCU
    zero_col = jnp.zeros((nblocks, 1), jnp.uint32)
    buf_ext = jnp.concatenate([buf, zero_col], axis=1)
    buf_prev = jnp.concatenate([zero_col, buf], axis=1)
    sb = (boff.reshape(nblocks) & 31)[:, None]
    shifted = (buf_ext >> sb.astype(jnp.uint32)) | jnp.where(
        sb > 0, buf_prev << jnp.clip(32 - sb, 0, 31).astype(jnp.uint32), 0
    )  # (B, block_words+2), aligned to the block's in-MCU bit offset
    ncb = block_words + 2
    base_b = (boff >> 5).reshape(nm, bpm)            # word lane of each block
    lane = jnp.arange(mcu_words + 1, dtype=jnp.int32)[None, None, None, :]
    idx = base_b[:, :, None] + jnp.arange(ncb, dtype=jnp.int32)[None, None, :]
    mcu_buf = jnp.sum(
        jnp.where(
            idx[:, :, :, None] == lane,
            shifted.reshape(nm, bpm, ncb)[:, :, :, None],
            jnp.uint32(0),
        ),
        axis=(1, 2),
        dtype=jnp.uint32,
    )  # (nm, mcu_words+1)
    return mcu_buf, t_m


def pack_blocks_tree(blocks, tbl, dc_code, dc_len, ac_code, ac_len,
                     nwords: int, bpm: int,
                     block_words: int = BLOCK_WORDS,
                     mcu_words: int | None = None,
                     split_hv: int | None = None,
                     fixed_tid: int | None = None,
                     lookup: str = "tree"):
    """Fused device pack straight from coefficient blocks: channel-wise
    level 1 (_level1_channels — no materialized 191-field record stream),
    block->MCU shift-combine, log-depth level-2 tree. Byte-identical to
    build_bitfields + pack_bits_tree; the default for the encoder's
    "tree" group.

    split_hv: when the caller's tbl follows the encoder's static
    [0]*hv + [1, 1] per-MCU pattern, pass hv to run the split fixed-id
    level 1 (_level1_channels_split — the default for color encodes). fixed_tid: all blocks share one table id (the
    grayscale encode path). tbl is ignored on both fast paths (the static
    pattern IS the table-id array)."""
    if mcu_words is None:
        mcu_words = bpm * 4
    if split_hv is not None:
        buf, t_b = _level1_channels_split(
            blocks, split_hv, dc_code, dc_len, ac_code, ac_len,
            block_words, lookup)
    elif fixed_tid is not None:
        buf, t_b = _level1_channels_fixed(
            blocks, fixed_tid, dc_code, dc_len, ac_code, ac_len,
            block_words, lookup)
    else:
        buf, t_b = _level1_channels(
            blocks, tbl, dc_code, dc_len, ac_code, ac_len, block_words)
    mcu_buf, t_m = _combine_to_mcu(buf, t_b, bpm, block_words, mcu_words)
    words, total = _level2(mcu_buf, t_m, nwords, "tree_or")
    ok = (
        (jnp.max(t_b) <= block_words * 32)
        & (jnp.max(t_m) <= mcu_words * 32)
        & (total <= nwords * 32)
    )
    return words, total, ok


def finalize_segment(words: np.ndarray, total_bits: int) -> np.ndarray:
    """Host side: trim to bytes, 1-pad the final byte, 0xFF-stuff."""
    from jpeg_tpu.entropy import encode_np

    total_bytes = (int(total_bits) + 7) // 8
    raw = np.ascontiguousarray(words[: (total_bytes + 3) // 4]).astype(">u4")
    out = raw.view(np.uint8)[:total_bytes].copy()
    rem = int(total_bits) & 7
    if rem:
        out[-1] |= (1 << (8 - rem)) - 1
    return encode_np._stuff_bytes(out)


def finalize_stream(words: np.ndarray, totals, rst_base: int = 0) -> bytes:
    """Finalize all of a device pack's word segments into one scan: per
    segment trim/1-pad/stuff, RSTn markers between segments. words is the
    HOST (nseg, W) uint32 array (callers fetch one slice for all segments);
    totals the (nseg,) bit counts. Uses the C++ runtime when available (one
    call per image), byte-identical to the NumPy fallback."""
    from jpeg_tpu.entropy import native

    words = np.asarray(words)
    if words.ndim == 1:
        words = words[None]
    totals = np.asarray(totals).astype(np.int64).reshape(-1)
    if native.available():
        return native.finalize_scan(words, totals, rst_base)
    parts = []
    for s, t in enumerate(totals):
        parts.append(finalize_segment(words[s], int(t)).tobytes())
        if s != len(totals) - 1:
            parts.append(bytes([0xFF, 0xD0 + ((rst_base + s) & 7)]))
    return b"".join(parts)
