"""Single-JFIF mosaic encode: BASELINE.json config 5 ("gigapixel mosaic ...
sharded across N>=2 hosts, DC/offset exchange via collectives, single JFIF").

One arbitrarily large image is sharded as horizontal MCU stripes over the
``mcu`` mesh axis (the devices of one host, or across hosts the same mesh
after jax.distributed.initialize — the code is identical, only mesh
construction changes). Each stripe:

  * computes its quantized/zig-zag blocks locally (transform sharded);
  * resolves its DC predictors — with stripe restarts (default) the RSTn
    marker resets the predictor so no exchange is needed; without restarts the
    previous stripe's last DC arrives via ppermute (parallel.shard);
  * is entropy-packed independently (C++ threads per restart segment).

The "bitstream offset exchange" of the reference contract reduces to an
exclusive prefix over per-stripe byte lengths because restart segments are
byte-aligned: the host gather concatenates [stripe bytes + RSTn] in mesh
order. The result is ONE spec-compliant JFIF stream.
"""

from __future__ import annotations

import numpy as np

from jpeg_tpu.parallel.batch import encode_batch
from jpeg_tpu.parallel.mesh import make_mesh


def encode_mosaic(
    image,
    quality: int = 75,
    subsampling="420",
    mesh=None,
    optimize_tables: bool = False,
    device_pack: bool = False,
) -> bytes:
    """Encode one large image into a single JFIF stream, stripe-sharded over
    the mesh's ``mcu`` axis. `image`: (H, W, 3) uint8, any size."""
    image = np.asarray(image)
    if image.ndim != 3 or image.shape[2] != 3:
        raise ValueError(f"expected (H, W, 3), got {image.shape}")
    if mesh is None:
        mesh = make_mesh(batch_axis=1)
    return encode_batch(
        image[None],
        quality=quality,
        subsampling=subsampling,
        mesh=mesh,
        stripe_restart=True,
        optimize_tables=optimize_tables,
        device_pack=device_pack,
    )[0]


def encode_mosaic_stream(
    source,
    height: int,
    width: int,
    quality: int = 75,
    subsampling="420",
    stripe_rows: int | None = None,
    rst_rows: int = 1,
    optimize_tables: bool = False,
    comment: str | None = None,
    out=None,
):
    """Memory-bounded gigapixel mosaic encode: one spec-compliant JFIF out,
    peak RSS bounded by a single stripe (BASELINE config 5 at contract scale —
    "16x 4K tiles" and beyond — without materializing the image).

    source: callable (row0, row1) -> uint8 (row1-row0, width, 3) pixel rows.
    Called once per stripe in top-to-bottom order (twice per stripe when
    optimize_tables=True: pass 1 gathers global symbol histograms, pass 2
    packs with the optimal tables).
    stripe_rows: rows per stripe (rounded to MCU-height multiples); default
    targets ~32 MB of pixels per stripe.
    rst_rows: MCU rows per restart segment — the scan's DRI is
    rst_rows * mcu_cols, so stripes splice at byte-aligned RSTn boundaries
    and DC predictors never cross a stripe (the streaming form of the
    restart-interval parallel seam, SURVEY.md §5).
    out: file-like for streamed writes; when None the bytes are returned.

    The emitted stream is byte-identical to encode(image, quality,
    subsampling, restart_interval=rst_rows*mcu_cols, optimize_tables=...) on
    the fully materialized image (tests/test_parallel.py).
    """
    from jpeg_tpu.config import EncodeConfig
    from jpeg_tpu.entropy import encode_np, huffman, native
    from jpeg_tpu.io import jfif
    from jpeg_tpu.models import encoder as E, layout
    from jpeg_tpu.ops import quant, tile

    import jax.numpy as jnp

    cfg = EncodeConfig(quality=quality, subsampling=subsampling)
    mode = cfg.subsampling
    mcu_h, mcu_w = mode.mcu_height, mode.mcu_width
    hf, vf = mode.h_factor, mode.v_factor
    hv = hf * vf
    if height <= 0 or width <= 0:
        raise ValueError(f"bad mosaic dims {height}x{width}")
    mcu_rows_total = -(-height // mcu_h)
    mcu_cols = -(-width // mcu_w)
    r = rst_rows * mcu_cols  # DRI in MCUs
    if r > 65535:
        raise ValueError(
            f"restart interval {r} exceeds the DRI field (reduce rst_rows "
            f"or the mosaic width)"
        )

    if stripe_rows is None:
        stripe_rows = max(1, int(32e6 // (3 * width)) // mcu_h) * mcu_h
    stripe_rows = max(mcu_h * rst_rows, stripe_rows // mcu_h * mcu_h)
    if (stripe_rows // mcu_h) % rst_rows:
        raise ValueError(
            f"stripe_rows={stripe_rows} is not a whole number of restart "
            f"groups (rst_rows={rst_rows}, MCU height {mcu_h})"
        )

    qy_np, qc_np = quant.luma_table(cfg.quality), quant.chroma_table(cfg.quality)
    qy, qc = jnp.asarray(qy_np), jnp.asarray(qc_np)
    tf = E._jit_color(mode)

    def stripes(per_stripe):
        """Drive source stripe by stripe, yielding DPCM'd interleaved blocks."""
        row0 = 0
        while row0 < height:
            rows = min(stripe_rows, height - row0)
            img = np.asarray(source(row0, row0 + rows))
            if img.shape != (rows, width, 3):
                raise ValueError(
                    f"source returned {img.shape}, expected {(rows, width, 3)}"
                )
            if img.dtype != np.uint8:
                img = np.clip(img, 0, 255).astype(np.uint8)
            padded = tile.pad_to_multiple(jnp.asarray(img), mcu_h, mcu_w)
            y_zz, cb_zz, cr_zz = (np.asarray(a) for a in tf(padded, qy, qc))
            s_mcu_rows = padded.shape[0] // mcu_h
            y_scan = y_zz[layout.mcu_scan_permutation(s_mcu_rows, mcu_cols, vf, hf)]
            y_scan = y_scan.copy()
            cb_zz, cr_zz = cb_zz.copy(), cr_zz.copy()
            y_scan[:, 0] = E._dpcm_host(y_scan[:, 0], r * hv)
            cb_zz[:, 0] = E._dpcm_host(cb_zz[:, 0], r)
            cr_zz[:, 0] = E._dpcm_host(cr_zz[:, 0], r)
            blocks, tbl = E.interleave_mcus(y_scan, cb_zz, cr_zz, hv)
            yield per_stripe(blocks, tbl, s_mcu_rows)
            row0 += rows

    if optimize_tables:
        # Pass 1: global symbol histograms, stripe at a time.
        hists = {k: np.zeros(256, dtype=np.int64)
                 for k in ((0, 0), (1, 0), (0, 1), (1, 1))}

        def accumulate(blocks, tbl, _rows):
            if native.available():
                f = native.count_frequencies(blocks, tbl)
            else:
                f = encode_np.count_frequencies(
                    encode_np.build_records(blocks, tbl, tbl)
                )
            for k in hists:
                hists[k] += np.asarray(f[k], dtype=np.int64)

        for _ in stripes(accumulate):
            pass
        htables = {k: huffman.optimal_table(v) for k, v in hists.items()}
    else:
        htables = huffman.standard_tables()

    sink = out if out is not None else None
    chunks = [] if sink is None else None

    def emit(b: bytes):
        if sink is None:
            chunks.append(b)
        else:
            sink.write(b)

    comps = [
        jfif.ComponentSpec(1, hf, vf, 0, 0, 0),
        jfif.ComponentSpec(2, 1, 1, 1, 1, 1),
        jfif.ComponentSpec(3, 1, 1, 1, 1, 1),
    ]
    emit(jfif.write_header(width, height, comps, {0: qy_np, 1: qc_np},
                           htables, restart_interval=r, comment=comment))

    state = {"seg": 0}  # global restart-segment counter across stripes
    bpm = hv + 2
    total_segs = -(-mcu_rows_total // rst_rows)

    def pack(blocks, tbl, s_mcu_rows):
        base = state["seg"]
        if native.available():
            chunk = native.encode_scan(
                blocks, tbl, htables, restart_interval=r,
                blocks_per_mcu=bpm, rst_base=base,
            )
        else:
            chunk = encode_np.encode_scan(
                blocks, tbl, tbl, htables, restart_interval=r,
                blocks_per_mcu=bpm, rst_base=base,
            )
        nseg = -(-s_mcu_rows // rst_rows)
        state["seg"] = base + nseg
        emit(chunk)
        if state["seg"] < total_segs:  # splice marker between stripes
            emit(bytes([0xFF, 0xD0 + ((state["seg"] - 1) & 7)]))

    for _ in stripes(pack):
        pass
    emit(b"\xff\xd9")  # EOI
    if sink is None:
        return b"".join(chunks)
    return None


def assemble_tiles(tiles) -> np.ndarray:
    """(R, C, h, w, 3) tile grid -> (R*h, C*w, 3) mosaic array."""
    t = np.asarray(tiles)
    r, c, h, w, ch = t.shape
    return t.transpose(0, 2, 1, 3, 4).reshape(r * h, c * w, ch)
