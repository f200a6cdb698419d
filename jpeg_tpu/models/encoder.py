"""The encoder pipeline: BMP/array -> JFIF JPEG bytes.

Accelerator replacement for `encode_bmp_to_jpeg` (src/jpg_encode.c:19-52) plus
everything the reference left unwritten (code assignment, bit packing, JFIF
emission — SURVEY.md component 10/11). The mutable `JpegData` blackboard
becomes a pure function pipeline:

  host: ingest -> device: [pad, RGB->YCbCr, level shift, subsample, DCT,
  quantize, zig-zag] as ONE jitted program -> host: MCU interleave, DPCM,
  entropy pack, JFIF assembly.

The device program is traced once per (shape, subsampling) — quality enters as
a quant-table *argument*, not a constant, so a quality sweep reuses the same
executable (cf. the reference re-scaling global tables in place,
src/quantise.c:34-35).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from jpeg_tpu.config import EncodeConfig, Subsampling
from jpeg_tpu.entropy import encode_np, huffman
from jpeg_tpu.entropy import native
from jpeg_tpu.ops import bitpack, dpcm as dpcm_ops
from jpeg_tpu.io import bmp, jfif
from jpeg_tpu.models import layout
from jpeg_tpu.ops import dct, quant, tile


# ---------------------------------------------------------------------------
# Device transform: pixels -> quantized zig-zag blocks (per-component raster).
# ---------------------------------------------------------------------------


def _zigzag_qtab(qtab):
    """(8, 8) quant table -> (64,) zig-zag-ordered f32 divisors (tiny static
    gather; runs once per program on 64 elements)."""
    from jpeg_tpu import tables

    return qtab.reshape(64)[jnp.asarray(tables.ZIGZAG_ORDER)].astype(jnp.float32)


def _plane_zz(plane, qtab, v: int = 1, h: int = 1):
    """Centered (H, W) f32 plane -> (B, 64) quantized zig-zag int32 blocks.

    One layout transpose (tile.blocks_scan_order — MCU scan order when
    v/h > 1, raster block order otherwise), one (64, 64) matmul that
    computes the 2-D DCT with the zig-zag permutation folded in
    (dct.fdct_zigzag_blocks), then the canonical round(coef/Q). The zig-zag
    reorder lives in the matmul, so no gather is needed."""
    flat = tile.blocks_scan_order(plane, v, h)
    zz = dct.fdct_zigzag_blocks(flat)
    return quant.round_half_away(zz / _zigzag_qtab(qtab)).astype(jnp.int32)


def _transform_color(rgb, qy, qc, mode: Subsampling):
    """uint8 (H, W, 3), H/W already MCU-aligned -> (y_zz, cb_zz, cr_zz) in
    raster block order per component.

    Runs the one-matmul MCU transform (ops/mcu_conv): color, level shift,
    subsampling, DCT and zig-zag in one contraction — the same math as the
    packed program, so host- and device-packed encodes stay byte-identical.
    """
    from jpeg_tpu.ops import mcu_conv

    hf, vf = mode.h_factor, mode.v_factor
    hv = hf * vf
    R = rgb.shape[0] // mode.mcu_height
    C = rgb.shape[1] // mode.mcu_width
    blocks = mcu_conv.mcu_transform(rgb, qy, qc, mode)  # (n_mcu, hv+2, 64)
    # Luma: MCU scan order -> plane raster order (one transpose).
    y_zz = blocks[:, :hv].reshape(R, C, vf, hf, 64).transpose(
        0, 2, 1, 3, 4).reshape(-1, 64)
    return y_zz, blocks[:, hv], blocks[:, hv + 1]


def _transform_gray(plane, qy):
    """Gray transform with the same backend routing as mcu_transform: CPU
    keeps the staged f32 form, accelerators the exact fixed-point matmul
    (bit-identical across executables — mcu_conv.gray_transform_int)."""
    if jax.default_backend() == "cpu":
        x = plane.astype(jnp.float32) - 128.0
        return _plane_zz(x, qy)
    from jpeg_tpu.ops import mcu_conv

    return mcu_conv.gray_transform_int(plane, qy)


@functools.cache
def _jit_color(mode: Subsampling):
    return jax.jit(functools.partial(_transform_color, mode=mode))


# ---------------------------------------------------------------------------
# Fully-fused device program: pixels -> packed scan words. Only the compressed
# stream leaves the device (SURVEY.md §7 step 6). Restart segments must tile
# the MCU count evenly (callers fall back to host packing otherwise).
# ---------------------------------------------------------------------------


# Device word-buffer capacity: 8 words (256 bits) per block average. Typical
# q75 blocks need ~30-100 bits; a stream denser than this makes the device
# packer report a total exceeding capacity and the encoder falls back to the
# host packer (exact, just slower), so correctness never depends on the cap.
WORDS_PER_BLOCK = 8


def _scan_components(rgb, qy, qc, mode: Subsampling, restart_mcus: int):
    """Pixels -> (y_scan, cb_zz, cr_zz, n_mcu, hv): per-component quantized
    zig-zag blocks straight out of the mega-conv (ops/mcu_conv) — already in
    MCU scan order, no transposes or gathers — with DC DPCM'd with restart
    resets."""
    from jpeg_tpu.ops import mcu_conv

    hv = mode.h_factor * mode.v_factor
    blocks = mcu_conv.mcu_transform(rgb, qy, qc, mode)  # (n_mcu, hv+2, 64)
    n_mcu = blocks.shape[0]
    y_scan = blocks[:, :hv].reshape(-1, 64)
    cb_zz = blocks[:, hv]
    cr_zz = blocks[:, hv + 1]

    r = int(restart_mcus)
    y_scan = y_scan.at[:, 0].set(dpcm_ops.dpcm(y_scan[:, 0], r * hv))
    cb_zz = cb_zz.at[:, 0].set(dpcm_ops.dpcm(cb_zz[:, 0], r))
    cr_zz = cr_zz.at[:, 0].set(dpcm_ops.dpcm(cr_zz[:, 0], r))
    return y_scan, cb_zz, cr_zz, n_mcu, hv


def _interleaved_blocks(rgb, qy, qc, mode: Subsampling, restart_mcus: int):
    """Device half shared by the packed and histogram programs: pixels ->
    (n_mcu * bpm, 64) MCU-interleaved DPCM'd blocks plus the (B,) table-id
    array. Luma comes out of the transform directly in MCU scan order (one
    transpose), interleave is an axis-1 concat — no gathers, no index-array
    arguments (the round-2 geometry arrays existed to dodge giant HLO
    literals; nothing here needs an index at all)."""
    y_scan, cb_zz, cr_zz, n_mcu, hv = _scan_components(
        rgb, qy, qc, mode, restart_mcus)
    blocks = jnp.concatenate(
        [y_scan.reshape(n_mcu, hv, 64), cb_zz[:, None], cr_zz[:, None]],
        axis=1,
    ).reshape(-1, 64)
    tbl_row = jnp.concatenate(
        [jnp.zeros((hv,), jnp.int32), jnp.ones((2,), jnp.int32)]
    )
    tbl = jnp.tile(tbl_row, n_mcu)
    return blocks, tbl, n_mcu, hv


def _transform_color_packed(
    rgb, qy, qc, dc_code, dc_len, ac_code, ac_len, *,
    mode: Subsampling, restart_mcus: int, group: str = "tree",
    scale: int = 1,
):
    """group: level-1/2 granularity of the packer — "tree" (default:
    narrow per-block level 1, block->MCU shift-combine, per-MCU level 2),
    "mcu" (one wide group per MCU, MCU budget only) or "block" (one group
    per 8x8 block, 288-bit budget). scale multiplies every word budget
    (per-block, per-MCU and stream capacity): the encoder's retry ladder for
    dense (q>=95) content that overflows the default caps runs the tree at
    scale 1, 2, then 4, then falls back to the host packer; all variants
    emit identical bytes when they fit."""
    blocks, tbl, n_mcu, hv = _interleaved_blocks(
        rgb, qy, qc, mode, restart_mcus)
    r = int(restart_mcus)
    bpm = hv + 2
    nblocks = n_mcu * bpm
    wpb = WORDS_PER_BLOCK * scale
    blk_w = bitpack.BLOCK_WORDS * scale
    if group == "tree":
        # Fused channel-wise level 1 straight from coefficients (no
        # materialized record stream) + block->MCU shift-combine + per-MCU
        # level-2 tree (bitpack.pack_blocks_tree) — per-MCU budget
        # bpm*160*scale bits (192 on the dense rungs) AND per-block budget
        # 288*scale bits (fallback beyond). Budget provenance: photographic
        # 4:2:0 q75 frames peak near 900-950 bits/MCU, so bpm*160 = 960 fits
        # them in one dispatch; the dense rungs use bpm*192*scale so q95
        # photos (~1900-2000 bits/MCU) fit the scale-2 program the dense
        # hint dispatches first; q98 rungs once more to scale 4.
        mcu_w = bpm * (5 if scale == 1 else 6) * scale
        if r == 0 or r >= n_mcu:
            nwords = nblocks * wpb + 2
            words, total, ok = bitpack.pack_blocks_tree(
                blocks, tbl, dc_code, dc_len, ac_code, ac_len,
                nwords, bpm, blk_w, mcu_w, split_hv=hv)
            return words[None], total[None], ok[None]
        nseg = n_mcu // r
        nwords = r * bpm * wpb + 2
        return jax.vmap(
            lambda b, t: bitpack.pack_blocks_tree(
                b, t, dc_code, dc_len, ac_code, ac_len, nwords, bpm,
                blk_w, mcu_w, split_hv=hv)
        )(blocks.reshape(nseg, -1, 64), tbl.reshape(nseg, -1))
    bits, nbits = bitpack.build_bitfields(
        blocks, tbl, dc_code, dc_len, ac_code, ac_len
    )
    if group == "mcu":
        fields = bpm * 191
        bw = bpm * 4 * scale  # 128*scale bits/block within the MCU budget
        bits = bits.reshape(-1, fields)
        nbits = nbits.reshape(-1, fields)
    else:
        fields, bw = 191, blk_w
    if r == 0 or r >= n_mcu:
        nwords = nblocks * wpb + 2
        words, total, ok = bitpack.pack_bits(bits, nbits, nwords, bw)
        return words[None], total[None], ok[None]
    # Equal restart segments (caller guarantees n_mcu % r == 0).
    nseg = n_mcu // r
    seg_blocks = r * bpm
    nwords = seg_blocks * wpb + 2
    bits = bits.reshape(nseg, -1, fields)
    nbits = nbits.reshape(nseg, -1, fields)
    return jax.vmap(
        lambda b, n: bitpack.pack_bits(b, n, nwords, bw))(bits, nbits)


@functools.cache
def _jit_color_packed(mode: Subsampling, restart_mcus: int,
                      group: str = "tree", scale: int = 1):
    return jax.jit(
        functools.partial(
            _transform_color_packed, mode=mode, restart_mcus=restart_mcus,
            group=group, scale=scale,
        )
    )


@functools.cache
def _jit_color_packed_batch(mode: Subsampling, restart_mcus: int):
    """K-image packed encode as ONE device program: vmap over a stacked
    (K, H, W, 3) batch. Amortizes the fixed per-dispatch cost across K
    images; output shapes grow a leading K axis.

    Bit-stability: the exact fixed-point transform makes this executable's
    bytes bit-identical to the single-image program's on every backend
    (nothing in the coefficient path depends on float rounding order) —
    chip_smoke.py checks batched == single on the GPU, and
    tests/test_bitpack.py pins it on CPU."""
    f = functools.partial(
        _transform_color_packed, mode=mode, restart_mcus=restart_mcus
    )
    return jax.jit(
        jax.vmap(f, in_axes=(0, None, None, None, None, None, None))
    )


def _transform_color_hists(rgb, qy, qc, *, mode: Subsampling,
                           restart_mcus: int):
    """Pass 1 of device-packed optimized-table encode: global symbol
    histograms [dc_luma, ac_luma, dc_chroma, ac_chroma] on device."""
    from jpeg_tpu.ops import symbols

    y_scan, cb_zz, cr_zz, _, _ = _scan_components(
        rgb, qy, qc, mode, restart_mcus)
    dc_l, ac_l = symbols.symbol_histogram(y_scan)
    dc_c1, ac_c1 = symbols.symbol_histogram(cb_zz)
    dc_c2, ac_c2 = symbols.symbol_histogram(cr_zz)
    return jnp.stack([dc_l, ac_l, dc_c1 + dc_c2, ac_c1 + ac_c2])


@functools.cache
def _jit_color_hists(mode: Subsampling, restart_mcus: int):
    return jax.jit(
        functools.partial(
            _transform_color_hists, mode=mode, restart_mcus=restart_mcus
        )
    )


@functools.cache
def _jit_gray():
    return jax.jit(_transform_gray)


def _transform_gray_packed(plane, qy, dc_code, dc_len, ac_code, ac_len, *,
                           restart_mcus: int):
    zz = _transform_gray(plane, qy)
    r = int(restart_mcus)
    zz = zz.at[:, 0].set(dpcm_ops.dpcm(zz[:, 0], r))
    tbl = jnp.zeros(zz.shape[0], jnp.int32)
    nblocks = zz.shape[0]
    # Fixed-id channel-wise level 1 (all blocks are luma): same 288-bit
    # per-block budget as the record-stream pack_bits this replaces, with
    # mcu_words matched so the per-"MCU" (= per-block at bpm=1) budget is
    # unchanged — bytes identical, none of the (B, 191) record
    # materializations.
    if r == 0 or r >= nblocks:
        nwords = nblocks * WORDS_PER_BLOCK + 2
        words, total, ok = bitpack.pack_blocks_tree(
            zz, tbl, dc_code, dc_len, ac_code, ac_len, nwords, 1,
            mcu_words=bitpack.BLOCK_WORDS, fixed_tid=0)
        return words[None], total[None], ok[None]
    nseg = -(-nblocks // r)
    # caller guarantees nblocks % r == 0 for the device path
    nwords = r * WORDS_PER_BLOCK + 2
    return jax.vmap(
        lambda b, t: bitpack.pack_blocks_tree(
            b, t, dc_code, dc_len, ac_code, ac_len, nwords, 1,
            mcu_words=bitpack.BLOCK_WORDS, fixed_tid=0)
    )(zz.reshape(nseg, r, 64), tbl.reshape(nseg, r))


@functools.cache
def _jit_gray_packed(restart_mcus: int):
    return jax.jit(
        functools.partial(_transform_gray_packed, restart_mcus=restart_mcus)
    )


def _transform_gray_hists(plane, qy, *, restart_mcus: int):
    """Pass 1 of device-packed optimized-table gray encode: [dc, ac] symbol
    histograms on device (mirrors _transform_color_hists)."""
    from jpeg_tpu.ops import symbols

    zz = _transform_gray(plane, qy)
    zz = zz.at[:, 0].set(dpcm_ops.dpcm(zz[:, 0], int(restart_mcus)))
    dc, ac = symbols.symbol_histogram(zz)
    return jnp.stack([dc, ac])


@functools.cache
def _jit_gray_hists(restart_mcus: int):
    return jax.jit(
        functools.partial(_transform_gray_hists, restart_mcus=restart_mcus)
    )


# ---------------------------------------------------------------------------
# Host assembly
# ---------------------------------------------------------------------------


def _normalize_image(image: np.ndarray) -> np.ndarray:
    """encode()'s input convention, shared by every entry point: floats are
    rounded then clipped; other dtypes clip to uint8."""
    image = np.asarray(image)
    if np.issubdtype(image.dtype, np.floating):
        return np.clip(np.round(image), 0, 255).astype(np.uint8)
    if image.dtype != np.uint8:
        return np.clip(image, 0, 255).astype(np.uint8)
    return image


def _normalize_quant_tables(quant_tables):
    if quant_tables is None:
        return None
    qt_y = np.clip(np.asarray(quant_tables[0], np.int32).reshape(8, 8), 1, 255)
    qt_c = np.clip(np.asarray(quant_tables[1], np.int32).reshape(8, 8), 1, 255)
    return (qt_y, qt_c)


def _color_components(mode: Subsampling):
    """The 3-component SOF spec every color writer shares."""
    return [
        jfif.ComponentSpec(1, mode.h_factor, mode.v_factor, 0, 0, 0),
        jfif.ComponentSpec(2, 1, 1, 1, 1, 1),
        jfif.ComponentSpec(3, 1, 1, 1, 1, 1),
    ]


def device_pack_retry(img, qy, qc, luts, mode: Subsampling, r: int,
                      skip_tree: bool = False, dense_hint: bool = False):
    """The device packed program with the overflow retry ladder — tree at
    scale 1 -> 2 -> 4 (every word budget multiplied) — shared by every
    caller that device-packs (encode(), encode_stream's finisher): q>=95
    content overflows the default caps and must stay on-device. Returns (words, totals, ok); ok=False after the ladder means
    the caller must host-pack.

    skip_tree resumes the ladder when the caller already ran the scale-1
    tree program itself. dense_hint starts the ladder at scale 2 directly:
    a failed scale-1 attempt costs a full device dispatch, so the encoder
    predicts dense content from the quantizer (mean step < 6 ~ IJG quality
    >= 93, where photographic blocks peak well past the 288-bit scale-1
    cap) and skips the attempt that would fail. Scale never changes bytes —
    only caps — so the hint is purely a dispatch-count choice."""
    ok = False
    words = totals = None
    scale = 2 if (skip_tree or dense_hint) else 1
    while not ok and scale <= 4:
        words, totals, ok = _jit_color_packed(mode, r, "tree", scale)(
            img, qy, qc, *luts)
        ok = bool(np.asarray(ok).all())
        scale *= 2
    return words, totals, ok


def _dpcm_host(dc: np.ndarray, reset_every: int) -> np.ndarray:
    prev = np.concatenate([[0], dc[:-1]])
    if reset_every:
        prev[np.arange(len(dc)) % reset_every == 0] = 0
    return dc - prev


def encode(
    image,
    quality: int = 75,
    subsampling="420",
    restart_interval: int | None = None,
    optimize_tables: bool = False,
    comment: str | None = None,
    device_pack: bool | None = None,
    quant_tables=None,
) -> bytes:
    """Encode an (H, W, 3) RGB or (H, W) grayscale uint8 array (or a .bmp path)
    to baseline JFIF JPEG bytes. The capability contract of jpg_encode.h:85,
    completed."""
    cfg = EncodeConfig(
        quality=quality,
        subsampling=subsampling,
        restart_interval=0 if restart_interval is None else restart_interval,
        optimize_tables=optimize_tables,
    )
    if isinstance(image, (str, bytes)) and not isinstance(image, np.ndarray):
        if isinstance(image, str):
            image = bmp.read_bmp(image)
        else:
            image = bmp.decode_bmp(image)
    image = _normalize_image(image)
    quant_tables = _normalize_quant_tables(quant_tables)
    if image.ndim == 2:
        return _encode_gray(image, cfg, comment, quant_tables, device_pack)
    if image.ndim == 3 and image.shape[2] == 3:
        return _encode_color(image, cfg, comment, device_pack, quant_tables)
    raise ValueError(f"expected (H, W, 3) or (H, W) image, got {image.shape}")


def encode_batched(
    images,
    quality: int = 75,
    subsampling="420",
    restart_interval: int = 0,
    comment: str | None = None,
    quant_tables=None,
    device_pack: bool | None = None,
) -> list[bytes]:
    """Encode K same-shape RGB images with ONE batched device program — the
    encode twin of decode_batched (single-chip dispatch-floor amortization;
    the bench's encode_batched_mpix_s row is this program). Returns one JFIF
    stream per image, byte-identical to per-image encode() (the exact
    fixed-point transform makes the batched executable bit-identical to the
    single-image one on every backend).

    Images must share (H, W); on CPU backends or device-pack overflow the
    whole batch transparently falls back to per-image encode()."""
    imgs = np.asarray(images)
    if imgs.ndim != 4 or imgs.shape[-1] != 3:
        raise ValueError(f"expected (K, H, W, 3) uint8, got {imgs.shape}")
    if imgs.shape[0] == 0:
        return []
    imgs = _normalize_image(imgs)
    cfg = EncodeConfig(quality=quality, subsampling=subsampling)
    mode = cfg.subsampling

    def per_image():
        # Forward device_pack so an explicit device_pack=False batch stays a
        # host-pack batch in the fallback (the flag's perf/intent
        # semantics must survive the per-image path; bytes never depended on
        # it).
        return [encode(im, quality=quality, subsampling=cfg.subsampling,
                       restart_interval=restart_interval, comment=comment,
                       device_pack=device_pack, quant_tables=quant_tables)
                for im in imgs]

    if device_pack is None:
        device_pack = jax.default_backend() != "cpu"
    r = int(restart_interval)
    h0, w0 = imgs.shape[1:3]
    ph = -h0 % mode.mcu_height
    pw = -w0 % mode.mcu_width
    n_mcu = ((h0 + ph) // mode.mcu_height) * ((w0 + pw) // mode.mcu_width)
    if not device_pack or (r != 0 and n_mcu % r != 0):
        return per_image()  # unaligned restart: same fallback as encode()
    batch = jnp.pad(jnp.asarray(imgs), ((0, 0), (0, ph), (0, pw), (0, 0)),
                    mode="edge")
    qt = _normalize_quant_tables(quant_tables)
    if qt is not None:
        qy_np, qc_np = qt
    else:
        qy_np = quant.luma_table(quality)
        qc_np = quant.chroma_table(quality)
    htables = huffman.standard_tables()
    luts = tuple(jnp.asarray(a) for a in bitpack.luts_from_tables(htables))
    words, totals, ok = _jit_color_packed_batch(mode, r)(
        batch, jnp.asarray(qy_np), jnp.asarray(qc_np), *luts
    )
    if not bool(np.asarray(ok).all()):
        return per_image()
    totals_np = np.asarray(totals)  # (K, 1)
    maxw = (int(totals_np.max()) + 31) // 32
    words_host = np.asarray(words[:, :, :maxw])  # one sliced fetch for all K
    comps = _color_components(mode)
    out = []
    for k in range(imgs.shape[0]):
        scan = bitpack.finalize_stream(words_host[k], totals_np[k])
        out.append(jfif.write_jpeg(
            w0, h0, comps, {0: qy_np, 1: qc_np}, htables, scan,
            restart_interval=r, comment=comment,
        ))
    return out


def encode_bmp_to_jpeg(input_path: str, output_path: str, quality: int = 75,
                       subsampling="444", **kw) -> None:
    """Drop-in analog of the reference entry point (jpg_encode.h:85)."""
    data = encode(bmp.read_bmp(input_path), quality=quality,
                  subsampling=subsampling, **kw)
    with open(output_path, "wb") as f:
        f.write(data)


def encode_rgb_to_jpeg(rgb, output_path: str, quality: int = 75,
                       subsampling="444", **kw) -> None:
    """Raw-RGB-array analog of the reference's declared-but-never-defined
    encode_rgb_to_jpeg (jpg_encode.h:99 — SURVEY.md component 3)."""
    data = encode(np.asarray(rgb), quality=quality, subsampling=subsampling, **kw)
    with open(output_path, "wb") as f:
        f.write(data)


def interleave_mcus(y_scan, cb_scan, cr_scan, hv: int):
    """Merge per-component scan-order blocks into one interleaved (B, 64) array
    plus the per-block table-id array (0 luma / 1 chroma)."""
    n_mcu = cb_scan.shape[0]
    bpm = hv + 2
    # int32 matches the device output dtype and the native packer ABI, so the
    # packers see this array zero-copy (int64 forced a ~2x-size convert-copy
    # of the whole coefficient stream on every encode).
    blocks = np.empty((n_mcu, bpm, 64), dtype=np.int32)
    blocks[:, :hv] = y_scan.reshape(n_mcu, hv, 64)
    blocks[:, hv] = cb_scan
    blocks[:, hv + 1] = cr_scan
    tbl = np.zeros((n_mcu, bpm), dtype=np.uint8)
    tbl[:, hv:] = 1
    return blocks.reshape(-1, 64), tbl.reshape(-1)


def _pack_scan(blocks, tbl, cfg: EncodeConfig, bpm: int):
    """Entropy-pack one scan, choosing tables and the fastest backend.

    Native (C++) path packs straight from coefficients; the NumPy path reuses
    the record stream. optimize_tables needs the record stream for frequencies
    either way.
    """
    records = None
    if cfg.optimize_tables:
        if native.available():
            freqs = native.count_frequencies(blocks, tbl)
        else:
            records = encode_np.build_records(blocks, tbl, tbl)
            freqs = encode_np.count_frequencies(records)
        htables = {k: huffman.optimal_table(v) for k, v in freqs.items()}
    else:
        htables = huffman.standard_tables()
    if native.available():
        scan = native.encode_scan(
            blocks, tbl, htables,
            restart_interval=cfg.restart_interval, blocks_per_mcu=bpm,
        )
    else:
        if records is None:
            records = encode_np.build_records(blocks, tbl, tbl)
        scan = encode_np.encode_scan(
            blocks, tbl, tbl, htables,
            restart_interval=cfg.restart_interval, blocks_per_mcu=bpm,
            records=records,
        )
    return scan, htables


def _encode_color(image: np.ndarray, cfg: EncodeConfig, comment,
                  device_pack: bool | None = None,
                  quant_tables=None) -> bytes:
    h0, w0 = image.shape[:2]
    mode = cfg.subsampling
    img = tile.pad_to_multiple(jnp.asarray(image), mode.mcu_height, mode.mcu_width)
    if quant_tables is not None:
        qy_np, qc_np = quant_tables
    else:
        qy_np, qc_np = quant.luma_table(cfg.quality), quant.chroma_table(cfg.quality)
    qy = jnp.asarray(qy_np)
    qc = jnp.asarray(qc_np)

    r = cfg.restart_interval
    n_mcu = (img.shape[0] // mode.mcu_height) * (img.shape[1] // mode.mcu_width)
    if device_pack is None:
        device_pack = jax.default_backend() != "cpu"
    pack_ok = r == 0 or n_mcu % r == 0
    if device_pack and pack_ok:
        if cfg.optimize_tables:
            # Pass 1: device symbol histograms -> per-image optimal tables.
            hists = np.asarray(_jit_color_hists(mode, r)(img, qy, qc))
            htables = {
                (0, 0): huffman.optimal_table(hists[0]),
                (1, 0): huffman.optimal_table(hists[1]),
                (0, 1): huffman.optimal_table(hists[2]),
                (1, 1): huffman.optimal_table(hists[3]),
            }
        else:
            htables = huffman.standard_tables()
        luts = tuple(jnp.asarray(a) for a in bitpack.luts_from_tables(htables))
        words, totals, ok = device_pack_retry(
            img, qy, qc, luts, mode, r,
            dense_hint=float(np.mean(qy_np)) < 6.0)
        totals_np = np.asarray(totals)
        if not ok:
            scan = None  # a block or segment overflowed the device caps: host pack
        else:
            # ONE sliced fetch for every segment, then one native finalize
            # call.
            maxw = (int(totals_np.max()) + 31) // 32
            w_host = np.asarray(words[:, :maxw])
            scan = bitpack.finalize_stream(w_host, totals_np)
    else:
        scan = None

    if scan is not None:
        comps = _color_components(mode)
        return jfif.write_jpeg(
            w0, h0, comps, {0: qy_np, 1: qc_np},
            htables, scan, restart_interval=r, comment=comment,
        )

    y_zz, cb_zz, cr_zz = _jit_color(mode)(img, qy, qc)
    y_zz, cb_zz, cr_zz = (np.asarray(a) for a in (y_zz, cb_zz, cr_zz))

    hp, wp = img.shape[:2]
    hf, vf = mode.h_factor, mode.v_factor
    mcu_rows, mcu_cols = hp // mode.mcu_height, wp // mode.mcu_width
    n_mcu = mcu_rows * mcu_cols
    hv = hf * vf

    # Raster -> scan order per component, then interleave per MCU.
    y_scan = y_zz[layout.mcu_scan_permutation(mcu_rows, mcu_cols, vf, hf)]
    cb_scan = cb_zz  # chroma sampling (1,1): raster == scan
    cr_scan = cr_zz

    r = cfg.restart_interval
    y_scan = y_scan.copy()
    cb_scan = cb_scan.copy()
    cr_scan = cr_scan.copy()
    y_scan[:, 0] = _dpcm_host(y_scan[:, 0], r * hv)
    cb_scan[:, 0] = _dpcm_host(cb_scan[:, 0], r)
    cr_scan[:, 0] = _dpcm_host(cr_scan[:, 0], r)

    bpm = hv + 2
    blocks, tbl = interleave_mcus(y_scan, cb_scan, cr_scan, hv)
    scan, htables = _pack_scan(blocks, tbl, cfg, bpm)

    comps = _color_components(mode)
    return jfif.write_jpeg(
        w0, h0, comps, {0: qy_np, 1: qc_np},
        htables, scan, restart_interval=r, comment=comment,
    )


def _encode_gray(image: np.ndarray, cfg: EncodeConfig, comment,
                 quant_tables=None, device_pack: bool | None = None) -> bytes:
    h0, w0 = image.shape
    img = tile.pad_to_multiple(jnp.asarray(image), 8, 8)
    qy_np = quant.luma_table(cfg.quality) if quant_tables is None else quant_tables[0]
    qy = jnp.asarray(qy_np)

    r0 = cfg.restart_interval
    nblocks = (img.shape[0] // 8) * (img.shape[1] // 8)
    if device_pack is None:
        device_pack = jax.default_backend() != "cpu"
    if device_pack and (r0 == 0 or nblocks % r0 == 0):
        if cfg.optimize_tables:
            # Pass 1: device symbol histograms -> per-image optimal tables
            # (same two-pass flow as the color path at _encode_color).
            hists = np.asarray(_jit_gray_hists(r0)(img, qy))
            htables_full = {
                (0, 0): huffman.optimal_table(hists[0]),
                (1, 0): huffman.optimal_table(hists[1]),
            }
        else:
            htables_full = huffman.standard_tables()
        luts = tuple(jnp.asarray(a) for a in bitpack.luts_from_tables(htables_full))
        words, totals, ok = _jit_gray_packed(r0)(img, qy, *luts)
        if bool(np.asarray(ok).all()):
            totals_np = np.asarray(totals)
            maxw = (int(totals_np.max()) + 31) // 32
            scan = bitpack.finalize_stream(
                np.asarray(words[:, :maxw]), totals_np)
            htables = {(0, 0): htables_full[(0, 0)], (1, 0): htables_full[(1, 0)]}
            comps = [jfif.ComponentSpec(1, 1, 1, 0, 0, 0)]
            return jfif.write_jpeg(
                w0, h0, comps, {0: qy_np}, htables, scan,
                restart_interval=r0, comment=comment,
            )

    zz = np.asarray(_jit_gray()(img, qy))  # raster == scan for one component

    r = cfg.restart_interval
    zz = zz.astype(np.int64)
    zz[:, 0] = _dpcm_host(zz[:, 0], r)
    tbl = np.zeros(zz.shape[0], dtype=np.int64)
    scan, all_tables = _pack_scan(zz, tbl, cfg, 1)
    htables = {(0, 0): all_tables[(0, 0)], (1, 0): all_tables[(1, 0)]}
    comps = [jfif.ComponentSpec(1, 1, 1, 0, 0, 0)]
    return jfif.write_jpeg(
        w0, h0, comps, {0: qy_np}, htables, scan,
        restart_interval=r, comment=comment,
    )
