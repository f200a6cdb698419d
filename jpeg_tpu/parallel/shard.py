"""shard_map'ed encode pipeline: batch + MCU-stripe parallelism.

The reference has no parallelism of any kind (SURVEY.md §2: "NONE exist");
this module supplies the first-class mapping a multi-device build owes:

  * ``batch`` axis: independent images, pure data parallelism;
  * ``mcu`` axis: horizontal MCU stripes of each image — the serial seams the
    reference created (DC DPCM chain, dpcm.c:10-20; single-accumulator Huffman
    stats, huffman.c:29-42) become:
      - a ``ppermute`` neighbor exchange of each stripe's last DC predictor
        (ring-style sequence parallelism over the MCU stream), and
      - a ``psum`` of per-stripe symbol histograms into the global frequency
        table used for Annex-K.2 optimized codes.

With ``stripe_restart=True`` each stripe is emitted as a restart segment
(DRI/RSTn), making stripes fully independent — the spec-native parallel seam —
and the DC exchange is skipped by construction (predictor resets at RSTn).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from jpeg_tpu.config import Subsampling
from jpeg_tpu.models import layout
from jpeg_tpu.models.encoder import _transform_color
from jpeg_tpu.ops import symbols
from jpeg_tpu.parallel import mesh as mesh_mod


def _stripe_transform(imgs, qy, qc, mode: Subsampling, mcu_cols: int):
    """Transform a stripe's images to scan-ordered per-component blocks."""
    hf, vf = mode.h_factor, mode.v_factor
    hv = hf * vf

    def one_image(img):
        y_zz, cb_zz, cr_zz = _transform_color(img, qy, qc, mode=mode)
        rows_local = y_zz.shape[0] // (mcu_cols * hv)
        # Raster -> MCU scan order as a reshape+transpose (no gather; same
        # values as the old mcu_scan_permutation row gather).
        y_scan = y_zz.reshape(rows_local, vf, mcu_cols, hf, 64).transpose(
            0, 2, 1, 3, 4).reshape(-1, 64)
        return y_scan, cb_zz, cr_zz

    return jax.vmap(one_image)(imgs)  # (b, n_local, 64) each, scan order


def _stripe_step(imgs, qy, qc, *, mode: Subsampling, mcu_cols: int,
                 stripe_restart: bool, sp: int):
    """Per-shard body. imgs: (b_local, h_local, W, 3) — one MCU-stripe block."""
    hf, vf = mode.h_factor, mode.v_factor
    hv = hf * vf
    y, cb, cr = _stripe_transform(imgs, qy, qc, mode, mcu_cols)

    def dpcm_shard(blocks):
        dc = blocks[:, :, 0]
        if stripe_restart or sp == 1:
            recv = jnp.zeros_like(dc[:, -1])
        else:
            recv = jax.lax.ppermute(
                dc[:, -1], "mcu", [(i, i + 1) for i in range(sp - 1)]
            )
        prev = jnp.concatenate([recv[:, None], dc[:, :-1]], axis=1)
        return blocks.at[:, :, 0].set(dc - prev)

    y, cb, cr = dpcm_shard(y), dpcm_shard(cb), dpcm_shard(cr)

    # Global symbol statistics: per-stripe histograms psum'd over the mesh —
    # every shard ends with the global tables' input.
    dc_l, ac_l = symbols.symbol_histogram(y.reshape(-1, 64))
    dc_c1, ac_c1 = symbols.symbol_histogram(cb.reshape(-1, 64))
    dc_c2, ac_c2 = symbols.symbol_histogram(cr.reshape(-1, 64))
    hists = jnp.stack([dc_l, ac_l, dc_c1 + dc_c2, ac_c1 + ac_c2])
    hists = jax.lax.psum(hists, ("batch", "mcu"))
    return y, cb, cr, hists


def _stripe_step_packed(imgs, qy, qc, dc_code, dc_len, ac_code, ac_len, *,
                        mode: Subsampling, mcu_cols: int, sp: int):
    """Per-shard body producing a PACKED restart segment per image: each
    stripe entropy-codes its own blocks on its own chip (the device version of
    'parallel Huffman bitstream stitch', BASELINE configs 4-5). Stripe
    restarts by construction, so no DC exchange is needed and segments are
    byte-aligned for the host stitch."""
    from jpeg_tpu.models.encoder import WORDS_PER_BLOCK
    from jpeg_tpu.ops import bitpack

    hf, vf = mode.h_factor, mode.v_factor
    hv = hf * vf
    y, cb, cr = _stripe_transform(imgs, qy, qc, mode, mcu_cols)

    def dpcm0(blocks):
        # predictor resets at the stripe start (it is a restart segment)
        dc = blocks[:, :, 0]
        prev = jnp.concatenate([jnp.zeros_like(dc[:, :1]), dc[:, :-1]], axis=1)
        return blocks.at[:, :, 0].set(dc - prev)

    y, cb, cr = dpcm0(y), dpcm0(cb), dpcm0(cr)

    n_mcu_local = cb.shape[1]
    tbl_row = jnp.concatenate(
        [jnp.zeros((hv,), jnp.int32), jnp.ones((2,), jnp.int32)]
    )
    tbl = jnp.tile(tbl_row, n_mcu_local)

    nblocks = n_mcu_local * (hv + 2)
    nwords = nblocks * WORDS_PER_BLOCK + 2

    def pack_one(yi, cbi, cri):
        # MCU interleave as an axis-1 concat (no gather).
        blocks = jnp.concatenate(
            [yi.reshape(n_mcu_local, hv, 64), cbi[:, None], cri[:, None]],
            axis=1,
        ).reshape(-1, 64)
        bits, nbits = bitpack.build_bitfields(
            blocks, tbl, dc_code, dc_len, ac_code, ac_len
        )
        # Same three-level tree pack as the single-chip path (byte-identical
        # to block grouping; probe 7i), with the MCU budget set to the full
        # per-block worst case so this path keeps EXACTLY the block
        # grouping's success envelope (the multichip dryrun asserts the
        # device pack never overflows on its tiny noisy images). Level-2
        # updates still drop ~(11*bpm -> bpm*9+2 per MCU).
        return bitpack.pack_bits_tree(
            bits, nbits, nwords, hv + 2,
            mcu_words=(hv + 2) * bitpack.BLOCK_WORDS,
        )

    words, totals, ok = jax.vmap(pack_one)(y, cb, cr)
    return words, totals[:, None], ok[:, None]


@functools.lru_cache(maxsize=64)
def _build_sharded_packed_fn(mesh: Mesh, mode: Subsampling, mcu_cols: int):
    fn = functools.partial(
        _stripe_step_packed, mode=mode, mcu_cols=mcu_cols, sp=mesh.shape["mcu"]
    )
    mapped = shard_map(
        fn,
        mesh=mesh,
        in_specs=(P("batch", "mcu"), P(), P(), P(), P(), P(), P()),
        out_specs=(P("batch", "mcu"), P("batch", "mcu"), P("batch", "mcu")),
        check_vma=False,
    )
    return jax.jit(mapped)


def sharded_encode_packed(imgs, qy, qc, huff: dict, mesh: Mesh,
                          mode: Subsampling = Subsampling.YUV420):
    """Distributed transform + per-stripe device entropy packing.

    Returns (words (B, sp*nwords) uint32, totals (B, sp) int32, ok (B, sp)
    bool): stripe s of image i occupies words[i, s*nwords:(s+1)*nwords] with
    totals[i, s] valid bits. Join segments with RSTn after host finalize.
    """
    from jpeg_tpu.ops import bitpack

    b, h, w = imgs.shape[0], imgs.shape[1], imgs.shape[2]
    dp, sp = mesh.shape["batch"], mesh.shape["mcu"]
    if b % dp or h % (mode.mcu_height * sp) or w % mode.mcu_width:
        raise ValueError(f"geometry {imgs.shape} not tileable over mesh {mesh.shape}")
    mcu_cols = w // mode.mcu_width
    luts = tuple(jnp.asarray(a) for a in bitpack.luts_from_tables(huff))
    fn = _build_sharded_packed_fn(mesh, mode, mcu_cols)
    spec = NamedSharding(mesh, P("batch", "mcu"))
    imgs = mesh_mod.host_to_global(imgs, spec)
    return fn(imgs, jnp.asarray(qy), jnp.asarray(qc), *luts)


@functools.lru_cache(maxsize=64)
def _build_sharded_hist_fn(mesh: Mesh, mode: Subsampling,
                           stripe_restart: bool, mcu_cols: int):
    step = functools.partial(
        _stripe_step, mode=mode, mcu_cols=mcu_cols,
        stripe_restart=stripe_restart, sp=mesh.shape["mcu"],
    )

    def hist_only(imgs, qy, qc):
        y, _, _, hists = step(imgs, qy, qc)
        # The 1-element sharded co-output is load-bearing: with ONLY the
        # replicated histogram as output, the SPMD partitioner chooses to
        # replicate the whole computation instead of partitioning it, which
        # changes the stripe structure (and thus the DPCM chains) and yields
        # wrong statistics. A sharded output pins the partitioning.
        return hists, y[:, :1, :1]

    mapped = shard_map(
        hist_only,
        mesh=mesh,
        in_specs=(P("batch", "mcu"), P(), P()),
        out_specs=(P(), P("batch", "mcu")),
        check_vma=False,
    )
    fn = jax.jit(mapped)
    return lambda *a: fn(*a)[0]


def sharded_histograms(imgs, qy, qc, mesh: Mesh,
                       mode: Subsampling = Subsampling.YUV420,
                       stripe_restart: bool = True):
    """Pass 1 of the device-packed optimized-table batch encode: global
    (4, 256) symbol histograms psum'd over the whole mesh, blocks never
    leaving the device. Same geometry contract as sharded_encode_blocks."""
    b, h, w = imgs.shape[0], imgs.shape[1], imgs.shape[2]
    dp, sp = mesh.shape["batch"], mesh.shape["mcu"]
    if b % dp or h % (mode.mcu_height * sp) or w % mode.mcu_width:
        raise ValueError(f"geometry {imgs.shape} not tileable over mesh {mesh.shape}")
    fn = _build_sharded_hist_fn(mesh, mode, bool(stripe_restart),
                                w // mode.mcu_width)
    spec = NamedSharding(mesh, P("batch", "mcu"))
    imgs = mesh_mod.host_to_global(imgs, spec)
    return fn(imgs, jnp.asarray(qy), jnp.asarray(qc))


@functools.lru_cache(maxsize=64)
def _build_sharded_fn(mesh: Mesh, mode: Subsampling, stripe_restart: bool,
                      mcu_cols: int):
    fn = functools.partial(
        _stripe_step, mode=mode, mcu_cols=mcu_cols,
        stripe_restart=stripe_restart, sp=mesh.shape["mcu"],
    )
    mapped = shard_map(
        fn,
        mesh=mesh,
        in_specs=(P("batch", "mcu"), P(), P()),
        out_specs=(P("batch", "mcu"), P("batch", "mcu"), P("batch", "mcu"), P()),
        check_vma=False,
    )
    return jax.jit(mapped)


def _halo_triangle_vertical(x, sp: int):
    """Vertical doubling with 3:1 triangular weights across stripe boundaries.

    x: (b, h_local, w) chroma stripe. The filter needs one row of halo on each
    side; boundary rows ride a ppermute ring exchange (edge stripes replicate,
    matching the unsharded edge behavior). Bit-identical to running
    subsample._triangle_axis on the unsharded plane.
    """
    if sp == 1:
        from jpeg_tpu.ops.subsample import _triangle_axis

        return jax.vmap(lambda p: _triangle_axis(p, 0))(x)
    idx = jax.lax.axis_index("mcu")
    from_above = jax.lax.ppermute(
        x[:, -1, :], "mcu", [(i, i + 1) for i in range(sp - 1)]
    )
    from_below = jax.lax.ppermute(
        x[:, 0, :], "mcu", [(i, i - 1) for i in range(1, sp)]
    )
    top = jnp.where(idx == 0, x[:, 0, :], from_above)
    bot = jnp.where(idx == sp - 1, x[:, -1, :], from_below)
    prev = jnp.concatenate([top[:, None, :], x[:, :-1, :]], axis=1)
    nxt = jnp.concatenate([x[:, 1:, :], bot[:, None, :]], axis=1)
    a = (3.0 * x + prev) * 0.25
    b = (3.0 * x + nxt) * 0.25
    bsz, h, w = x.shape
    return jnp.stack([a, b], axis=2).reshape(bsz, 2 * h, w)


def _stripe_decode(y, cb, cr, qy, qc, *, mode: Subsampling, mcu_cols: int,
                   sp: int):
    """Per-shard decode finishing: raster zig-zag blocks -> RGB pixels."""
    from jpeg_tpu.ops import color, dct, quant, subsample, tile, zigzag

    hf, vf = mode.h_factor, mode.v_factor

    def plane(zz, qtab, wb):
        # MUST stay the exact op sequence of models.decoder's
        # _reconstruct_plane (including its backend branch) so sharded output
        # is bit-identical to single-device decode (integer samples,
        # range-limited before upsampling/color — libjpeg semantics).
        from jpeg_tpu import tables

        hb = zz.shape[0] // wb
        if jax.default_backend() == "cpu":
            blocks = zigzag.from_zigzag(zz.reshape(hb, wb, 64))
            coeff = quant.dequantize(blocks, qtab)
            p = tile.unblockify(dct.idct_blocks(coeff)) + 128.0
        else:
            qz = qtab.reshape(64)[jnp.asarray(tables.ZIGZAG_ORDER)].astype(
                jnp.float32)
            flat = dct.idct_zigzag_blocks(
                zz.reshape(-1, 64).astype(jnp.float32) * qz)
            p = tile.plane_from_scan_blocks(flat, hb, wb) + 128.0
        return jnp.clip(jnp.round(p), 0.0, 255.0)

    yp = jax.vmap(lambda z: plane(z, qy, mcu_cols * hf))(y)
    cbp = jax.vmap(lambda z: plane(z, qc, mcu_cols))(cb)
    crp = jax.vmap(lambda z: plane(z, qc, mcu_cols))(cr)

    def up(p):
        # horizontal triangle doubling is width-local (4:1:1's x4 chains two
        # doublings, same order as subsample.fancy_upsample_factors); vertical
        # needs cross-stripe halos.
        f = hf
        while f > 1:
            p = jax.vmap(lambda q: subsample._triangle_axis(q, 1))(p)
            f //= 2
        if vf == 2:
            p = _halo_triangle_vertical(p, sp)
        return p

    cbp, crp = up(cbp), up(crp)
    ycc = jnp.stack([yp, cbp, crp], axis=-1)
    rgb = color.ycbcr_to_rgb(ycc, clip=False)
    return jnp.clip(jnp.round(rgb), 0, 255).astype(jnp.uint8)


@functools.lru_cache(maxsize=64)
def _build_sharded_decode(mesh: Mesh, mode: Subsampling, mcu_cols: int):
    fn = functools.partial(
        _stripe_decode, mode=mode, mcu_cols=mcu_cols, sp=mesh.shape["mcu"]
    )
    mapped = shard_map(
        fn,
        mesh=mesh,
        in_specs=(P("batch", "mcu"), P("batch", "mcu"), P("batch", "mcu"),
                  P(), P()),
        out_specs=P("batch", "mcu"),
        check_vma=False,
    )
    return jax.jit(mapped)


def sharded_decode_pixels(y_zz, cb_zz, cr_zz, qy, qc, mcu_cols: int,
                          mesh: Mesh,
                          mode: Subsampling = Subsampling.YUV420):
    """Distributed decode finishing: per-component (B, N, 64) zig-zag blocks
    in PLANE RASTER order -> (B, H, W, 3) uint8, sharded over (batch, stripe).

    Entropy decode happens on hosts (C++ threads per restart segment); this is
    the device half, with cross-stripe halo exchange for the triangular chroma
    upsample so results are bit-identical to the single-device decoder. The
    MCU-row count must divide evenly over the ``mcu`` axis.
    """
    spec = NamedSharding(mesh, P("batch", "mcu"))
    y_zz = mesh_mod.host_to_global(y_zz, spec)
    cb_zz = mesh_mod.host_to_global(cb_zz, spec)
    cr_zz = mesh_mod.host_to_global(cr_zz, spec)
    fn = _build_sharded_decode(mesh, mode, int(mcu_cols))
    return fn(y_zz, cb_zz, cr_zz, jnp.asarray(qy), jnp.asarray(qc))


def sharded_encode_blocks(
    imgs,
    qy,
    qc,
    mesh: Mesh,
    mode: Subsampling = Subsampling.YUV420,
    stripe_restart: bool = False,
):
    """Run the distributed transform.

    imgs: (B, H, W, 3) uint8, H and W already multiples of the MCU size, with
    B divisible by the ``batch`` axis and H/mcu_height by the ``mcu`` axis.

    Returns (y, cb, cr, hists): per-component (B, N_comp, 64) int32 zig-zag
    blocks in MCU scan order with DC already DPCM'd (cross-stripe predictors
    exchanged via ppermute unless stripe_restart), and (4, 256) global symbol
    histograms [dc_luma, ac_luma, dc_chroma, ac_chroma].
    """
    b, h, w = imgs.shape[0], imgs.shape[1], imgs.shape[2]
    dp = mesh.shape["batch"]
    sp = mesh.shape["mcu"]
    if b % dp:
        raise ValueError(f"batch {b} not divisible by batch axis {dp}")
    if h % (mode.mcu_height * sp):
        raise ValueError(
            f"height {h} not divisible by {sp} stripes of {mode.mcu_height}"
        )
    if w % mode.mcu_width:
        raise ValueError(f"width {w} not a multiple of {mode.mcu_width}")
    mcu_cols = w // mode.mcu_width
    fn = _build_sharded_fn(mesh, mode, bool(stripe_restart), mcu_cols)
    spec = NamedSharding(mesh, P("batch", "mcu"))
    imgs = mesh_mod.host_to_global(imgs, spec)
    return fn(imgs, jnp.asarray(qy), jnp.asarray(qc))
