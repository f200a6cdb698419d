"""Host<->device pipelined streaming encode (the PP row of SURVEY.md §2's
parallelism table: JPEG's stages are too cheap to pipeline across chips, so
the pipeline parallelism that matters is overlapping host work — entropy
finalization, JFIF assembly, ingest — with the device transform of the NEXT
image, riding JAX's async dispatch).
"""

from __future__ import annotations

import collections
from typing import Iterable, Iterator

import jax
import jax.numpy as jnp
import numpy as np

from jpeg_tpu.config import EncodeConfig, _as_subsampling
from jpeg_tpu.entropy import huffman
from jpeg_tpu.io import jfif
from jpeg_tpu.models import encoder as E
from jpeg_tpu.ops import bitpack, quant, tile


def encode_stream(
    images: Iterable[np.ndarray],
    quality: int = 75,
    subsampling="420",
    depth: int = 2,
    device_pack: bool | None = None,
    optimize_tables: bool = False,
) -> Iterator[bytes]:
    """Encode a stream of RGB images, keeping `depth` device transforms in
    flight while the host finalizes earlier ones. Yields JFIF bytes in order.

    optimize_tables: per-image optimal Huffman
    tables WITHOUT breaking the pipeline — the image uploads once, its
    histogram program dispatches immediately (riding the async stream with
    image i+1's upload), and the packed program launches at finish time
    with that image's optimal LUTs as arguments (same compiled executable —
    the tables are runtime args, not compile constants). Costs one extra
    device program per image, no extra transfer.

    Images may vary in size — each distinct geometry compiles once.
    """
    cfg = EncodeConfig(quality=quality, subsampling=_as_subsampling(subsampling))
    mode = cfg.subsampling
    if device_pack is None:
        device_pack = jax.default_backend() != "cpu"

    htables = huffman.standard_tables()
    luts = tuple(jnp.asarray(a) for a in bitpack.luts_from_tables(htables))
    qy = jnp.asarray(quant.luma_table(cfg.quality))
    qc = jnp.asarray(quant.chroma_table(cfg.quality))
    qy_np = quant.luma_table(cfg.quality)
    qc_np = quant.chroma_table(cfg.quality)
    dense = float(np.mean(qy_np)) < 6.0  # encode()'s dense-content hint

    def dispatch(img: np.ndarray):
        img = E._normalize_image(img)  # encode()'s float/dtype convention
        if img.ndim != 3 or img.shape[2] != 3:
            raise ValueError(f"expected (H, W, 3), got {img.shape}")
        h0, w0 = img.shape[:2]
        dev = tile.pad_to_multiple(
            jnp.asarray(img), mode.mcu_height, mode.mcu_width
        )
        if not device_pack:
            cfg_ot = EncodeConfig(
                quality=quality, subsampling=cfg.subsampling,
                optimize_tables=optimize_tables)
            return ("host", img, cfg_ot)
        if optimize_tables:
            hists = E._jit_color_hists(mode, 0)(dev, qy, qc)  # async
            return ("device_opt", img, (h0, w0, dev, hists))
        if dense:
            # Dense-content hint (same gate as encode()): the scale-1 tree
            # program would overflow and cost a wasted dispatch — go
            # straight to scale 2.
            out = E._jit_color_packed(mode, 0, "tree", 2)(
                dev, qy, qc, *luts)
            return ("device2", img, (h0, w0, dev, out))
        out = E._jit_color_packed(mode, 0)(dev, qy, qc, *luts)
        return ("device", img, (h0, w0, dev, out))

    def finish(item) -> bytes:
        kind, img, payload = item
        if kind == "host":
            return E._encode_color(img, payload, None, device_pack=False)
        if kind == "device_opt":
            h0, w0, dev, hists = payload
            hists = np.asarray(hists)
            ht = {
                (0, 0): huffman.optimal_table(hists[0]),
                (1, 0): huffman.optimal_table(hists[1]),
                (0, 1): huffman.optimal_table(hists[2]),
                (1, 1): huffman.optimal_table(hists[3]),
            }
            l_img = tuple(
                jnp.asarray(a) for a in bitpack.luts_from_tables(ht))
            words, totals, ok = E.device_pack_retry(
                dev, qy, qc, l_img, mode, 0, dense_hint=dense)
            if not ok:
                cfg_ot = EncodeConfig(
                    quality=quality, subsampling=cfg.subsampling,
                    optimize_tables=True)
                return E._encode_color(img, cfg_ot, None, device_pack=False)
            t = int(np.asarray(totals)[0])
            w_host = np.asarray(words[:, : (t + 31) // 32])
            scan = bitpack.finalize_stream(w_host, [t])
            comps = E._color_components(mode)
            return jfif.write_jpeg(
                w0, h0, comps, {0: qy_np, 1: qc_np}, ht, scan
            )
        h0, w0, dev, (words, totals, ok) = payload
        if not bool(np.asarray(ok).all()):
            if kind == "device2":
                # The dispatched program was already the scale-2 rung;
                # continue at scale 4 before abandoning the device.
                words, totals, ok2 = E._jit_color_packed(
                    mode, 0, "tree", 4)(dev, qy, qc, *luts)
                ok2 = bool(np.asarray(ok2).all())
            else:
                # Resume the shared overflow retry ladder (tree at scale 2
                # -> 4) before abandoning the device — dense q>=95 frames
                # would otherwise silently host-pack the whole stream.
                words, totals, ok2 = E.device_pack_retry(
                    dev, qy, qc, luts, mode, 0, skip_tree=True)
            if not ok2:
                return E._encode_color(img, cfg, None, device_pack=False)
        t = int(np.asarray(totals)[0])
        w_host = np.asarray(words[:, : (t + 31) // 32])
        scan = bitpack.finalize_stream(w_host, [t])
        comps = E._color_components(mode)
        return jfif.write_jpeg(
            w0, h0, comps, {0: qy_np, 1: qc_np}, htables, scan
        )

    pending: collections.deque = collections.deque()
    for img in images:
        pending.append(dispatch(img))
        if len(pending) > depth:
            yield finish(pending.popleft())
    while pending:
        yield finish(pending.popleft())


def decode_stream(
    datas: Iterable[bytes],
    fancy_upsample: bool = True,
    scale_denom: int = 1,
    depth: int = 2,
    entropy: str = "auto",
    device_output: bool = False,
) -> Iterator[np.ndarray]:
    """Decode a stream of JPEGs, keeping `depth` decodes in flight on worker
    threads so the host entropy walk of stream i+1 overlaps the device
    programs (payload upload, densify, finish) of stream i — the serving
    shape bench.py measures as "decode pipelined" (the decode twin of
    encode_stream). Yields decoded arrays in input order.

    Streams may differ in geometry, sampling, tables — each decode is fully
    independent (unlike decode_batched's one-program homogeneous batch)."""
    from concurrent.futures import ThreadPoolExecutor

    from jpeg_tpu.models.decoder import decode

    with ThreadPoolExecutor(max(2, depth)) as pool:
        pending: collections.deque = collections.deque()
        for d in datas:
            pending.append(pool.submit(
                decode, d, fancy_upsample=fancy_upsample,
                scale_denom=scale_denom, entropy=entropy,
                device_output=True,
            ))
            if len(pending) > depth:
                out = pending.popleft().result()
                yield out if device_output else np.asarray(out)
        while pending:
            out = pending.popleft().result()
            yield out if device_output else np.asarray(out)
