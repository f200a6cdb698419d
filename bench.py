"""Benchmark: 4K (3840x2160) q75 4:2:0 encode and decode on one GPU.

    python3 bench.py

Runs in one process on the GPU and fails when JAX finds none: there is no
CPU fallback. Prints the card (name, power limit) on stderr, progress lines
on stderr, and ONE JSON line on stdout whose "device" names the card by
device_kind. Every timing ends in block_until_ready or a host copy of the
result. The compile cache follows JAX_COMPILATION_CACHE_DIR when set, else
<repo>/.jax_cache.

The input is a seeded photographic-like frame (jpeg_tpu.utils.synth). Rows:
single-call encode latency; pipelined x16 and batched x8 encode; the q95
scale-2 program; encode stages (transform, pack, d2h, host finalize);
decode device-resident, program only, pipelined, batched, to host, ycbcr
with host finish, stages (host walk, entropy, finish) and scale_denom=8;
BASELINE config 4 (64 x 4K streamed encode) and config 5 (16 x 4K mosaic
as one JFIF).
"""

from __future__ import annotations

import json
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

import chip_smoke

BASELINE_MPIX_S = 0.20  # reference, 1 CPU core (BASELINE.md)


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def best_ms(f, n: int = 5) -> float:
    """Fastest of n calls of f (waited on), in ms, after one warm call."""
    chip_smoke.wall(f)
    return min(chip_smoke.wall(f)[1] for _ in range(n)) * 1e3


def pipelined_ms(f, n: int = 16) -> float:
    """Per-call ms of n back-to-back dispatches of f, waited on once."""
    import jax

    jax.block_until_ready(f())
    t0 = time.perf_counter()
    out = [f() for _ in range(n)]
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / n * 1e3


def main(h: int = 2160, w: int = 3840) -> int:
    import jax
    import jax.numpy as jnp

    if jax.default_backend() != "gpu":
        log(f"no GPU: JAX backend is {jax.default_backend()!r}")
        return 2
    chip_smoke.use_compile_cache()
    dev0 = jax.devices()[0]
    log(f"card: {chip_smoke.card_line()}")

    from jpeg_tpu import decode, decode_batched, encode, finish_ycbcr
    from jpeg_tpu.config import Subsampling
    from jpeg_tpu.entropy import huffman, native
    from jpeg_tpu.io import jfif
    from jpeg_tpu.models import decoder as D, encoder as E, layout as L
    from jpeg_tpu.ops import bitpack, mcu_conv, quant
    from jpeg_tpu.parallel.mosaic import encode_mosaic_stream
    from jpeg_tpu.parallel.pipeline import encode_stream
    from jpeg_tpu.utils import synth

    img = synth.photo(h, w, seed=0)
    mpix = h * w / 1e6
    mode = Subsampling.YUV420
    dev_img = jax.device_put(jnp.asarray(img))
    qy_np, qc_np = quant.luma_table(75), quant.chroma_table(75)
    qy, qc = jnp.asarray(qy_np), jnp.asarray(qc_np)
    htables = huffman.standard_tables()
    luts = tuple(jnp.asarray(a) for a in bitpack.luts_from_tables(htables))
    fn = E._jit_color_packed(mode, 0)
    comps = E._color_components(mode)

    def finalize(out):
        words, totals, _ = out
        t = int(np.asarray(totals)[0])
        scan = bitpack.finalize_stream(
            np.asarray(words[:, : (t + 31) // 32]), [t])
        return jfif.write_jpeg(w, h, comps, {0: qy_np, 1: qc_np}, htables,
                               scan)

    jpg = encode(img, quality=75, subsampling="420")
    assert finalize(fn(dev_img, qy, qc, *luts)) == jpg
    res = {}

    # --- encode ---------------------------------------------------------
    lat_ms = best_ms(lambda: encode(img, quality=75, subsampling="420"))
    res["encode_latency_ms"] = lat_ms
    log(f"encode (host pixels -> JFIF): {lat_ms:.3f} ms")

    K = 16
    with ThreadPoolExecutor(2) as pool:
        t0 = time.perf_counter()
        outs = [fn(dev_img, qy, qc, *luts) for _ in range(K)]
        jpgs = list(pool.map(finalize, outs))
        pipe_ms = (time.perf_counter() - t0) / K * 1e3
    assert all(j == jpg for j in jpgs)
    res["encode_pipelined_mpix_s"] = mpix / pipe_ms * 1e3
    log(f"encode pipelined x{K} (device-resident pixels): {pipe_ms:.3f} ms")

    KB = 8
    fnb = E._jit_color_packed_batch(mode, 0)
    batch = jnp.broadcast_to(dev_img, (KB, *dev_img.shape))
    ob = fnb(batch, qy, qc, *luts)
    assert np.array_equal(np.asarray(ob[0][0, 0]),
                          np.asarray(fn(dev_img, qy, qc, *luts)[0][0]))
    bat_ms = pipelined_ms(lambda: fnb(batch, qy, qc, *luts), 4) / KB
    res["encode_batched_mpix_s"] = mpix / bat_ms * 1e3
    log(f"encode batched x{KB} program: {bat_ms:.3f} ms/img")

    qy95 = jnp.asarray(quant.luma_table(95))
    qc95 = jnp.asarray(quant.chroma_table(95))
    fn95 = E._jit_color_packed(mode, 0, "tree", 2)
    assert bool(np.asarray(fn95(dev_img, qy95, qc95, *luts)[2]).all())
    q95_ms = pipelined_ms(lambda: fn95(dev_img, qy95, qc95, *luts), 4)
    res["encode_q95_mpix_s"] = mpix / q95_ms * 1e3
    log(f"encode q95 scale-2 program: {q95_ms:.3f} ms")

    transform = jax.jit(lambda x: mcu_conv.mcu_transform(x, qy, qc, mode))
    out = fn(dev_img, qy, qc, *luts)
    t = int(np.asarray(out[1])[0])
    w_host = np.asarray(out[0][:, : (t + 31) // 32])
    stages = {
        "h2d_ms": best_ms(lambda: jax.device_put(img)),
        "transform_ms": pipelined_ms(lambda: transform(dev_img)),
        "program_ms": pipelined_ms(lambda: fn(dev_img, qy, qc, *luts)),
        "d2h_ms": best_ms(lambda: np.asarray(out[0][0, : (t + 31) // 32])),
        "host_ms": best_ms(lambda: jfif.write_jpeg(
            w, h, comps, {0: qy_np, 1: qc_np}, htables,
            bitpack.finalize_stream(w_host, [t]))),
    }
    stages["pack_ms"] = stages["program_ms"] - stages["transform_ms"]
    res["encode_stages"] = stages
    log(f"encode stages: {stages}")

    # --- decode ---------------------------------------------------------
    res_ms = best_ms(lambda: decode(jpg, device_output=True))
    res["decode_mpix_s"] = mpix / res_ms * 1e3
    prog, args = chip_smoke.decode_program(jpg)
    prog_ms = pipelined_ms(lambda: prog(*args))
    res["decode_program_mpix_s"] = mpix / prog_ms * 1e3
    log(f"decode device-resident {res_ms:.3f} ms, program {prog_ms:.3f} ms")

    KD = 16
    with ThreadPoolExecutor(2) as pool:
        t0 = time.perf_counter()
        douts = list(pool.map(
            lambda _: decode(jpg, device_output=True), range(KD)))
        jax.block_until_ready(douts)
        dpipe_ms = (time.perf_counter() - t0) / KD * 1e3
    res["decode_pipelined_mpix_s"] = mpix / dpipe_ms * 1e3

    KBD = 4
    dbat_ms = best_ms(
        lambda: decode_batched([jpg] * KBD, device_output=True), 2) / KBD
    res["decode_batched_mpix_s"] = mpix / dbat_ms * 1e3

    host_px = decode(jpg)
    host_ms = best_ms(lambda: decode(jpg))
    res["decode_to_host_mpix_s"] = mpix / host_ms * 1e3
    assert np.array_equal(finish_ycbcr(decode(jpg, output="ycbcr")), host_px)
    yc_ms = best_ms(lambda: finish_ycbcr(decode(jpg, output="ycbcr")))
    res["decode_ycbcr_to_host_mpix_s"] = mpix / yc_ms * 1e3
    log(f"decode pipelined {dpipe_ms:.3f}, batched {dbat_ms:.3f} ms/img, "
        f"to host {host_ms:.3f}, ycbcr+host finish {yc_ms:.3f} ms")

    info = jfif.parse_jpeg(jpg)
    n_mcu = L.ceil_div(h, 16) * L.ceil_div(w, 16)
    ml = [(i, c.h * c.v, c.dc_id, c.ac_id)
          for i, c in enumerate(info.components)]
    dstages = {
        "walk_ms": best_ms(lambda: native.sparse_scan(
            info.scan_data, n_mcu, ml, info.htables, info.restart_interval)),
        "entropy_ms": best_ms(
            lambda: D._decode_scan(info, n_mcu, ml, "auto"), 3),
        "finish_ms": prog_ms,
    }
    res["decode_stages"] = dstages
    s8_ms = best_ms(lambda: decode(jpg, scale_denom=8))
    res["decode_scale8_to_host_mpix_s"] = mpix / s8_ms * 1e3
    log(f"decode stages: {dstages}; scale_denom=8 {s8_ms:.3f} ms")

    # --- BASELINE config 4: 64 x 4K streamed encode ----------------------
    t0 = time.perf_counter()
    n64 = sum(1 for _ in encode_stream(
        (np.roll(img, 13 * i, axis=0) for i in range(64)), quality=75))
    el = time.perf_counter() - t0
    res["encode_batch64_mpix_s"] = n64 * mpix / el
    log(f"config 4: 64 x 4K stream in {el:.3f} s")

    # --- BASELINE config 5: 16 x 4K tiles as one JFIF --------------------
    mh, mw = 4 * h, 4 * w
    t0 = time.perf_counter()
    jpg_m = encode_mosaic_stream(
        lambda r0, r1: np.tile(img[np.arange(r0, r1) % h], (1, 4, 1)),
        mh, mw, quality=75, subsampling="420")
    el = time.perf_counter() - t0
    assert jfif.parse_jpeg(jpg_m).width == mw
    res["encode_mosaic16_mpix_s"] = mh * mw / 1e6 / el
    log(f"config 5: {mh}x{mw} mosaic in {el:.3f} s")

    rate = res["encode_pipelined_mpix_s"]
    print(json.dumps({
        "metric": "4K q75 4:2:0 encode, device-resident pipelined",
        "value": rate,
        "unit": "MPix/s",
        "vs_baseline": rate / BASELINE_MPIX_S,
        "device": {"platform": dev0.platform, "kind": dev0.device_kind,
                   "count": len(jax.devices())},
        **res,
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
