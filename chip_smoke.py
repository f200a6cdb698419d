"""Proof that the JPEG encode/decode main path runs on an NVIDIA GPU.

    python3 chip_smoke.py          # one GPU: every single-device phase
    python3 chip_smoke.py --four   # four GPUs: only the sharded mesh path

Each phase drives the public entry points at full size, checks the result
against the repo's plain references, and prints one line with its times. The
card's name and power limit come next, and the last line is one JSON object:

    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}

Exactness contract checked on the card:
  * encode bytes equal the plain reference — the integer transform
    (ops/mcu_conv) run on the CPU device plus the NumPy entropy coder
    (entropy/encode_np) — with zero tolerance, since the arithmetic is
    integer;
  * encode_batched bytes equal single encode() bytes;
  * the five entropy decode backends give bit-identical coefficients;
  * GPU decode pixels are within +-1 of the same decode placed on the CPU
    device (the IDCT runs at Precision.HIGHEST, full float32 on the GPU);
  * decode(output="ycbcr") + finish_ycbcr equals RGB decode exactly.

Without a GPU, or when any phase fails, the script exits non-zero and prints
no result line. It runs in one process and starts no other that imports JAX.
The compile cache lives where JAX_COMPILATION_CACHE_DIR says, else in
<repo>/.jax_cache.
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import os
import runpy
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))


# ---------------------------------------------------------------------------
# Environment
# ---------------------------------------------------------------------------


def compile_cache_dir(root: str = REPO) -> str:
    """JAX_COMPILATION_CACHE_DIR when set, else the fixed <root>/.jax_cache
    (a fixed path, because the path is part of what a cache hit needs)."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or os.path.join(
        root, ".jax_cache")


def use_compile_cache(root: str = REPO) -> str:
    """Point JAX's persistent compile cache at compile_cache_dir(root).
    When the variable is set JAX already reads it, and it is left alone."""
    import jax

    path = compile_cache_dir(root)
    if "JAX_COMPILATION_CACHE_DIR" not in os.environ:
        jax.config.update("jax_compilation_cache_dir", path)
    return path


def card_line() -> str:
    """`name, power.limit` of every visible card, as nvidia-smi prints it."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip()


# ---------------------------------------------------------------------------
# Comparison helpers
# ---------------------------------------------------------------------------


def first_mismatch(got: bytes, want: bytes) -> int | None:
    """Offset of the first differing byte (a length difference counts at the
    shorter length), or None when equal."""
    got, want = bytes(got), bytes(want)
    if got == want:
        return None
    a = np.frombuffer(got, np.uint8)
    b = np.frombuffer(want, np.uint8)
    n = min(a.size, b.size)
    diff = np.nonzero(a[:n] != b[:n])[0]
    return int(diff[0]) if diff.size else n


def require_same_bytes(what: str, got: bytes, want: bytes) -> None:
    off = first_mismatch(got, want)
    if off is not None:
        raise AssertionError(
            f"{what}: {len(got)} bytes vs reference {len(want)} bytes, "
            f"first difference at offset {off}")


def pixel_delta(got, want) -> tuple[int, float]:
    """(max |got - want|, share of samples that differ)."""
    a = np.asarray(got, np.int16)
    b = np.asarray(want, np.int16)
    if a.shape != b.shape:
        raise AssertionError(f"shape {a.shape} != {b.shape}")
    d = np.abs(a - b)
    return int(d.max(initial=0)), float(np.count_nonzero(d) / max(d.size, 1))


def psnr_chunked(a, b, rows: int = 512) -> float:
    """PSNR over arrays too large for one float64 copy."""
    se = 0.0
    for r in range(0, a.shape[0], rows):
        d = a[r:r + rows].astype(np.float64) - b[r:r + rows]
        se += float(np.sum(d * d))
    mse = se / a.size
    return float("inf") if mse == 0 else 10.0 * np.log10(255.0 ** 2 / mse)


# ---------------------------------------------------------------------------
# The plain encode reference: integer transform on the CPU device + NumPy
# entropy coder + the JFIF writer.
# ---------------------------------------------------------------------------


def _dpcm(dc: np.ndarray, reset_every: int) -> np.ndarray:
    prev = np.concatenate([[0], dc[:-1]])
    if reset_every:
        prev[np.arange(dc.size) % reset_every == 0] = 0
    return dc - prev


def reference_encode(image, quality: int = 75, subsampling="420",
                     restart_interval: int = 0,
                     optimize_tables: bool = False) -> bytes:
    """Baseline JFIF bytes for a uint8 (H, W, 3) or (H, W) image, computed
    without the encoder module: ops/mcu_conv's integer transform jitted onto
    the CPU device, DPCM and MCU interleave in NumPy, entropy/encode_np."""
    import jax

    from jpeg_tpu.config import _as_subsampling
    from jpeg_tpu.entropy import encode_np, huffman
    from jpeg_tpu.io import jfif
    from jpeg_tpu.ops import mcu_conv, quant

    cpu = jax.devices("cpu")[0]
    image = np.asarray(image)
    h0, w0 = image.shape[:2]
    r = int(restart_interval)
    qy = quant.luma_table(quality)
    qc = quant.chroma_table(quality)
    put = functools.partial(jax.device_put, device=cpu)
    if image.ndim == 2:
        ph, pw = -h0 % 8, -w0 % 8
        plane = np.pad(image, ((0, ph), (0, pw)), mode="edge")
        zz = np.array(jax.jit(mcu_conv.gray_transform_int)(
            put(plane), put(qy)))
        zz[:, 0] = _dpcm(zz[:, 0], r)
        blocks, tbl, bpm = zz, np.zeros(zz.shape[0], np.int64), 1
        comps = [jfif.ComponentSpec(1, 1, 1, 0, 0, 0)]
        qtabs = {0: qy}
        keys = ((0, 0), (1, 0))
    else:
        mode = _as_subsampling(subsampling)
        hv = mode.h_factor * mode.v_factor
        bpm = hv + 2
        ph, pw = -h0 % mode.mcu_height, -w0 % mode.mcu_width
        rgb = np.pad(image, ((0, ph), (0, pw), (0, 0)), mode="edge")
        mcus = np.array(jax.jit(functools.partial(
            mcu_conv._mcu_transform_int, mode=mode))(
                put(rgb), put(qy), put(qc)))  # (n_mcu, bpm, 64), scan order
        y = mcus[:, :hv].reshape(-1, 64)
        y[:, 0] = _dpcm(y[:, 0], r * hv)
        mcus[:, :hv] = y.reshape(-1, hv, 64)
        for c in (hv, hv + 1):
            mcus[:, c, 0] = _dpcm(mcus[:, c, 0], r)
        blocks = mcus.reshape(-1, 64)
        tbl = np.tile(np.array([0] * hv + [1, 1], np.int64), mcus.shape[0])
        comps = [jfif.ComponentSpec(1, mode.h_factor, mode.v_factor, 0, 0, 0),
                 jfif.ComponentSpec(2, 1, 1, 1, 1, 1),
                 jfif.ComponentSpec(3, 1, 1, 1, 1, 1)]
        qtabs = {0: qy, 1: qc}
        keys = ((0, 0), (1, 0), (0, 1), (1, 1))
    records = encode_np.build_records(blocks, tbl, tbl)
    if optimize_tables:
        freqs = encode_np.count_frequencies(records)
        htables = {k: huffman.optimal_table(freqs[k]) for k in keys}
    else:
        std = huffman.standard_tables()
        htables = {k: std[k] for k in keys}
    scan = encode_np.encode_scan(blocks, tbl, tbl, htables,
                                 restart_interval=r, blocks_per_mcu=bpm,
                                 records=records)
    return jfif.write_jpeg(w0, h0, comps, qtabs, htables, scan,
                           restart_interval=r)


def decode_on_cpu(data: bytes, **kw) -> np.ndarray:
    """decoder.decode placed on the CPU device: the same code path as on the
    GPU (routing follows the default backend), run by XLA's CPU compiler."""
    import jax

    from jpeg_tpu import decode

    with jax.default_device(jax.devices("cpu")[0]):
        return np.asarray(decode(data, **kw))


# ---------------------------------------------------------------------------
# Timing and reporting
# ---------------------------------------------------------------------------


def wall(fn):
    """(result, seconds) of fn(), waiting for any device arrays it returns."""
    import jax

    t0 = time.perf_counter()
    out = jax.block_until_ready(fn())
    return out, time.perf_counter() - t0


def steady_ms(fn, reps: int = 5) -> float:
    """Median milliseconds of fn() after one warm call (compiles excluded)."""
    wall(fn)
    return 1e3 * statistics.median(wall(fn)[1] for _ in range(reps))


def report(phase: str, **fields) -> None:
    parts = [f"{k}={float(v)!r}" if isinstance(v, float) else f"{k}={v}"
             for k, v in fields.items()]
    print(f"phase {phase}: ok " + " ".join(parts), flush=True)


@dataclasses.dataclass(frozen=True)
class Sizes:
    """Frame sizes of the phases. The defaults are what the script runs:
    4K (3840x2160) for the main path and its batches and streams, 1080p for
    the encode variants, sixteen 4K tiles for the mosaic."""

    big: tuple = (2160, 3840)
    variant: tuple = (1080, 1920)
    batch: int = 8
    stream: int = 16
    mosaic_tiles: tuple = (4, 4)


def distinct_frames(base: np.ndarray, n: int) -> list:
    """n distinct frames from one generated photo (rolls and flips)."""
    out = []
    for i in range(n):
        f = np.roll(base, (97 * i, 131 * i), axis=(0, 1))
        out.append(np.ascontiguousarray(f[:, ::-1] if i % 2 else f))
    return out


# ---------------------------------------------------------------------------
# One-GPU phases
# ---------------------------------------------------------------------------


def phase_encode_decode_4k(img) -> bytes:
    from jpeg_tpu import decode, encode, finish_ycbcr

    jpg, first_s = wall(lambda: encode(img, quality=75, subsampling="420"))
    enc_ms = steady_ms(lambda: encode(img, quality=75, subsampling="420"))
    want, ref_s = wall(lambda: reference_encode(img, 75, "420"))
    require_same_bytes("4K q75 4:2:0 encode", jpg, want)
    report("encode_4k_q75_420", bytes=len(jpg), reference="identical",
           first_call_s=first_s, steady_ms=enc_ms, reference_s=ref_s)

    px, first_s = wall(lambda: decode(jpg))
    dec_ms = steady_ms(lambda: decode(jpg))
    cpu_px = decode_on_cpu(jpg)
    dmax, share = pixel_delta(px, cpu_px)
    if dmax > 1:
        raise AssertionError(f"4K decode differs from CPU decode by {dmax}")
    err = np.abs(px.astype(np.int16) - img).max()
    report("decode_4k", shape=px.shape, max_delta_vs_cpu=dmax,
           share_differing=share, max_err_vs_source=int(err),
           first_call_s=first_s, steady_ms=dec_ms)

    fin = finish_ycbcr(decode(jpg, output="ycbcr"))
    if not np.array_equal(fin, px):
        raise AssertionError("finish_ycbcr != RGB decode")
    report("ycbcr_finish_4k", equal_to_rgb=True)
    return jpg


def phase_xla_stages(img) -> None:
    """Device time of the plain XLA programs on the hot path, by
    block_until_ready timing: the 4K 4:2:0 transform, pack level 1, the
    whole packed encode program, and the decode finish program — the
    baseline a hand-written kernel would have to beat end to end."""
    import jax
    import jax.numpy as jnp

    from jpeg_tpu import encode
    from jpeg_tpu.config import Subsampling
    from jpeg_tpu.entropy import huffman
    from jpeg_tpu.models import encoder as E
    from jpeg_tpu.ops import bitpack, mcu_conv, quant, tile

    mode = Subsampling.YUV420
    hv = mode.h_factor * mode.v_factor
    dev = tile.pad_to_multiple(jnp.asarray(img), mode.mcu_height,
                               mode.mcu_width)
    qy = jnp.asarray(quant.luma_table(75))
    qc = jnp.asarray(quant.chroma_table(75))
    luts = tuple(jnp.asarray(a) for a in
                 bitpack.luts_from_tables(huffman.standard_tables()))
    transform = jax.jit(functools.partial(mcu_conv._mcu_transform_int,
                                          mode=mode))
    blocks = jax.jit(lambda x: E._interleaved_blocks(x, qy, qc, mode, 0)[0])(
        dev)
    level1 = jax.jit(lambda b: bitpack._level1_channels_split(
        b, hv, *luts, block_words=bitpack.BLOCK_WORDS))
    packed = E._jit_color_packed(mode, 0)
    fin, args = decode_program(encode(img, quality=75, subsampling="420"))
    report("xla_stages_4k",
           transform_ms=steady_ms(lambda: transform(dev, qy, qc), 20),
           pack_level1_ms=steady_ms(lambda: level1(blocks), 20),
           packed_program_ms=steady_ms(lambda: packed(dev, qy, qc, *luts), 20),
           decode_finish_ms=steady_ms(lambda: fin(*args), 20))


def decode_program(jpg: bytes):
    """(jitted sparse finish program, device args) of a 3-component baseline
    stream — the device half of decode(), with the payload resident."""
    import jax
    import jax.numpy as jnp

    from jpeg_tpu.entropy import decode_device
    from jpeg_tpu.io import jfif
    from jpeg_tpu.models import decoder as D, layout

    info = jfif.parse_jpeg(jpg)
    comps = info.components
    hmax = max(c.h for c in comps)
    vmax = max(c.v for c in comps)
    mcu_rows = layout.ceil_div(info.height, 8 * vmax)
    mcu_cols = layout.ceil_div(info.width, 8 * hmax)
    n_mcu = mcu_rows * mcu_cols
    ml = [(i, c.h * c.v, c.dc_id, c.ac_id) for i, c in enumerate(comps)]
    payload, B, Sp, Ep, Edp = decode_device.sparse_payload(
        info.scan_data, n_mcu, ml, info.htables, info.restart_interval)
    fn = D._jit_finish_color_sparse(
        B, Sp, Ep, Edp, *D.component_ranges(comps, mcu_rows, mcu_cols),
        tuple((mcu_rows * c.v, mcu_cols * c.h) for c in comps),
        tuple((hmax // c.h, vmax // c.v) for c in comps),
        D.upsample_choices(info.width, comps, hmax, True), False, 8)
    args = (jax.device_put(jnp.asarray(payload)),
            *(jnp.asarray(info.qtables[c.qtab_id]) for c in comps))
    return fn, args


def encode_variants(width: int) -> tuple:
    """(name, encode kwargs) of the variant phases; the restart variant puts
    one restart segment on every MCU row."""
    row = -(-width // 16)
    return (
        ("q95_420_dense_hint", dict(quality=95, subsampling="420")),
        ("q75_422", dict(quality=75, subsampling="422")),
        ("q75_444", dict(quality=75, subsampling="444")),
        ("q75_gray", dict(quality=75)),
        ("q75_420_restart_row", dict(quality=75, subsampling="420",
                                     restart_interval=row)),
        ("q75_420_optimized", dict(quality=75, subsampling="420",
                                   optimize_tables=True)),
    )


def phase_variants(img) -> dict:
    """Encode variants at >= 1080p, each byte-identical to the reference and
    decoded within +-1 of the CPU device. Returns the streams by name."""
    from jpeg_tpu import decode, encode

    out = {}
    for name, kw in encode_variants(img.shape[1]):
        src = np.ascontiguousarray(img[..., 1]) if "gray" in name else img
        jpg, first_s = wall(lambda: encode(src, **kw))
        want = reference_encode(src, **kw)
        require_same_bytes(f"{name} encode", jpg, want)
        px = decode(jpg)
        dmax, share = pixel_delta(px, decode_on_cpu(jpg))
        if dmax > 1:
            raise AssertionError(f"{name} decode differs from CPU by {dmax}")
        report(f"encode_{name}", shape=src.shape, bytes=len(jpg),
               reference="identical", first_call_s=first_s,
               steady_ms=steady_ms(lambda: encode(src, **kw), 3),
               decode_max_delta_vs_cpu=dmax, decode_share_differing=share)
        out[name] = jpg
    return out


def phase_entropy_backends(streams: dict) -> None:
    """All five scan decoders give bit-identical coefficients, on a
    restart-free stream and on a stream with one restart per MCU row."""
    from jpeg_tpu.io import jfif
    from jpeg_tpu.models import decoder as D, layout

    for name in ("q75_422", "q75_420_restart_row"):
        info = jfif.parse_jpeg(streams[name])
        comps = info.components
        hmax = max(c.h for c in comps)
        vmax = max(c.v for c in comps)
        n_mcu = (layout.ceil_div(info.height, 8 * vmax)
                 * layout.ceil_div(info.width, 8 * hmax))
        ml = [(i, c.h * c.v, c.dc_id, c.ac_id) for i, c in enumerate(comps)]
        times = {}
        coeffs = {}
        for be in ("numpy", "native", "device", "indexed", "sparse"):
            got, s = wall(lambda: D._decode_scan(info, n_mcu, ml, be))
            coeffs[be] = [np.asarray(g) for g in got]
            times[f"{be}_s"] = s
        for be, cs in coeffs.items():
            for a, b in zip(cs, coeffs["numpy"]):
                if not np.array_equal(a, b):
                    raise AssertionError(f"{name}: {be} coefficients differ")
        report(f"entropy_backends_{name}", identical=5, **times)


def phase_batched(frames, singles) -> None:
    from jpeg_tpu import decode, decode_batched, encode_batched

    batch = np.stack(frames)
    outs, first_s = wall(lambda: encode_batched(batch, quality=75))
    for k, (got, want) in enumerate(zip(outs, singles)):
        require_same_bytes(f"encode_batched[{k}]", got, want)
    enc_ms = steady_ms(lambda: encode_batched(batch, quality=75), 3)
    report(f"encode_batched_x{len(frames)}_4k", equal_to_single=True,
           first_call_s=first_s, steady_ms=enc_ms)
    px, first_s = wall(lambda: decode_batched(singles))
    for k, jpg in enumerate(singles):
        if not np.array_equal(px[k], decode(jpg)):
            raise AssertionError(f"decode_batched[{k}] != decode")
    report(f"decode_batched_x{len(frames)}_4k", equal_to_single=True,
           first_call_s=first_s,
           steady_ms=steady_ms(lambda: decode_batched(singles), 3))


def phase_streams(frames, singles) -> None:
    from jpeg_tpu import decode, decode_stream, encode_stream

    n = len(frames)
    t0 = time.perf_counter()
    outs = list(encode_stream(frames, quality=75))
    enc_s = time.perf_counter() - t0
    for k, (got, want) in enumerate(zip(outs, singles)):
        require_same_bytes(f"encode_stream[{k}]", got, want)
    t0 = time.perf_counter()
    pxs = list(decode_stream(outs))
    dec_s = time.perf_counter() - t0
    for k, jpg in enumerate(outs):
        if not np.array_equal(pxs[k], decode(jpg)):
            raise AssertionError(f"decode_stream[{k}] != decode")
    report(f"streams_x{n}_4k", equal_to_single=True,
           encode_stream_s=enc_s, decode_stream_s=dec_s)


def phase_scaled(jpg: bytes, shape) -> None:
    from jpeg_tpu import decode

    px, first_s = wall(lambda: decode(jpg, scale_denom=8))
    want_shape = (-(-shape[0] // 8), -(-shape[1] // 8), 3)
    if px.shape != want_shape:
        raise AssertionError(f"scale_denom=8 shape {px.shape}")
    dmax, share = pixel_delta(px, decode_on_cpu(jpg, scale_denom=8))
    if dmax > 1:
        raise AssertionError(f"scaled decode differs from CPU by {dmax}")
    report("decode_scale8_4k", shape=px.shape, max_delta_vs_cpu=dmax,
           share_differing=share, first_call_s=first_s,
           steady_ms=steady_ms(lambda: decode(jpg, scale_denom=8)))


def _mosaic(base, tiles) -> np.ndarray:
    th, tw = base.shape[:2]
    out = np.empty((tiles[0] * th, tiles[1] * tw, 3), np.uint8)
    for i, f in enumerate(distinct_frames(base, tiles[0] * tiles[1])):
        r, c = divmod(i, tiles[1])
        out[r * th:(r + 1) * th, c * tw:(c + 1) * tw] = f
    return out


def phase_mosaic(base, tiles) -> None:
    """BASELINE config 5: sixteen 4K tiles as one JFIF (15360x8640),
    streamed stripe by stripe, decoded by the repo's decoder."""
    from jpeg_tpu import decode
    from jpeg_tpu.parallel.mosaic import encode_mosaic_stream

    src = _mosaic(base, tiles)
    h, w = src.shape[:2]
    jpg, enc_s = wall(lambda: encode_mosaic_stream(
        lambda r0, r1: src[r0:r1], h, w, quality=75, subsampling="420"))
    px, dec_s = wall(lambda: decode(jpg))
    if px.shape != src.shape:
        raise AssertionError(f"mosaic decoded to {px.shape}")
    p = psnr_chunked(px, src)
    if not p >= 30.0:
        raise AssertionError(f"mosaic PSNR {p:.2f} dB < 30")
    report("mosaic_16x4k", shape=src.shape, bytes=len(jpg), psnr_db=p,
           encode_s=enc_s, decode_s=dec_s,
           encode_mpix_s=h * w / 1e6 / enc_s)


def phase_cli(img) -> None:
    """One `python -m jpeg_tpu encode` call, run in this process (runpy) so
    the card keeps a single JAX process."""
    from jpeg_tpu import encode
    from jpeg_tpu.io import bmp

    with tempfile.TemporaryDirectory() as d:
        src, dst = os.path.join(d, "in.bmp"), os.path.join(d, "out.jpg")
        bmp.write_bmp(src, img)
        argv, sys.argv = sys.argv, ["jpeg_tpu", "encode", src, dst,
                                    "--quality", "85"]
        try:
            runpy.run_module("jpeg_tpu", run_name="__main__")
        except SystemExit as e:
            if e.code not in (0, None):
                raise AssertionError(f"CLI exited with {e.code}") from e
        finally:
            sys.argv = argv
        with open(dst, "rb") as f:
            got = f.read()
    require_same_bytes("CLI encode", got, encode(img, quality=85))
    report("cli_encode", bytes=len(got), equal_to_api=True)


def run_one_card(sizes: Sizes = Sizes()) -> None:
    from jpeg_tpu import encode
    from jpeg_tpu.utils import synth

    h, w = sizes.big
    base = synth.photo(h, w, seed=0)
    jpg = phase_encode_decode_4k(base)
    phase_xla_stages(base)
    streams = phase_variants(synth.photo(*sizes.variant, seed=1))
    phase_entropy_backends(streams)
    frames = distinct_frames(base, max(sizes.batch, sizes.stream))
    singles = [encode(f, quality=75) for f in frames]
    phase_batched(frames[:sizes.batch], singles[:sizes.batch])
    phase_streams(frames[:sizes.stream], singles[:sizes.stream])
    phase_scaled(jpg, base.shape)
    phase_mosaic(base, sizes.mosaic_tiles)
    phase_cli(base[: sizes.variant[0], : sizes.variant[1]])


# ---------------------------------------------------------------------------
# Four-GPU path
# ---------------------------------------------------------------------------


def run_four_cards(sizes: Sizes = Sizes()) -> None:
    """The sharded path on four devices, compared with single-device
    encode()/decode(): 8 x 4K frames data-parallel over a (4, 1) mesh (a 4K
    frame's 135 MCU rows cannot split into equal stripes), then MCU-stripe
    parallelism over make_mesh(4)'s (2, 2) mesh and a (1, 4) mesh on frames
    of four stacked 4K tiles (8640 x 3840)."""
    import jax

    from jpeg_tpu import decode, encode
    from jpeg_tpu.config import Subsampling
    from jpeg_tpu.entropy import huffman
    from jpeg_tpu.ops import bitpack, quant
    from jpeg_tpu.parallel import batch as pbatch, shard
    from jpeg_tpu.parallel.mesh import make_mesh
    from jpeg_tpu.parallel.mosaic import encode_mosaic
    from jpeg_tpu.utils import synth

    if len(jax.devices()) < 4:
        raise SystemExit(f"--four needs 4 devices, have {len(jax.devices())}")
    mode = Subsampling.YUV420
    h, w = sizes.big
    base = synth.photo(h, w, seed=0)
    frames = np.stack(distinct_frames(base, sizes.batch))

    dp_mesh = make_mesh(4, batch_axis=4)
    jpgs, enc_s = wall(lambda: pbatch.encode_batch(
        frames, quality=75, subsampling="420", mesh=dp_mesh,
        device_pack=True))
    for i, got in enumerate(jpgs):
        require_same_bytes(f"encode_batch[{i}]", got,
                           encode(frames[i], quality=75, subsampling="420"))
    report(f"mesh_encode_batch_x{len(frames)}_4k", mesh="4x1",
           equal_to_single=True, first_call_s=enc_s,
           steady_ms=steady_ms(lambda: pbatch.encode_batch(
               frames, quality=75, subsampling="420", mesh=dp_mesh,
               device_pack=True), 3))
    px, dec_s = wall(lambda: pbatch.decode_batch(jpgs, mesh=dp_mesh))
    for i, jpg in enumerate(jpgs):
        if not np.array_equal(np.asarray(px[i]), decode(jpg)):
            raise AssertionError(f"decode_batch[{i}] != decode")
    report(f"mesh_decode_batch_x{len(frames)}_4k", mesh="4x1",
           equal_to_single=True, first_call_s=dec_s,
           steady_ms=steady_ms(
               lambda: pbatch.decode_batch(jpgs, mesh=dp_mesh), 3))

    tiles = distinct_frames(base, 4)
    tall = np.stack([np.concatenate(tiles[k:] + tiles[:k], axis=0)
                     for k in range(2)])  # 2 frames of 4 stacked 4K tiles
    mcu_cols = -(-w // mode.mcu_width)
    mesh = make_mesh(4)
    dp, sp = mesh.shape["batch"], mesh.shape["mcu"]
    dri = tall.shape[1] // mode.mcu_height // sp * mcu_cols
    jt, s = wall(lambda: pbatch.encode_batch(
        tall, quality=75, subsampling="420", mesh=mesh, device_pack=True))
    singles = [encode(t, quality=75, subsampling="420", restart_interval=dri)
               for t in tall]
    for i, got in enumerate(jt):
        require_same_bytes(f"striped encode_batch[{i}]", got, singles[i])
    pt = pbatch.decode_batch(jt, mesh=mesh)
    for i, jpg in enumerate(jt):
        if not np.array_equal(np.asarray(pt[i]), decode(jpg)):
            raise AssertionError(f"striped decode_batch[{i}] != decode")
    report(f"mesh_striped_batch_x{len(tall)}", shape=tall.shape[1:],
           mesh=f"{dp}x{sp}",
           equal_to_single=True, encode_first_call_s=s)

    words, totals, ok = shard.sharded_encode_packed(
        tall, quant.luma_table(75), quant.chroma_table(75),
        huffman.standard_tables(), mesh, mode)
    if not bool(np.asarray(ok).all()):
        raise AssertionError("sharded_encode_packed overflowed")
    nseg = np.asarray(totals).shape[1]
    for i in range(len(tall)):
        scan = bitpack.finalize_stream(
            np.asarray(words[i]).reshape(nseg, -1), np.asarray(totals[i]))
        if scan not in singles[i]:
            raise AssertionError(f"sharded_encode_packed[{i}] scan differs")
    report("mesh_sharded_encode_packed", mesh=f"{dp}x{sp}", segments=nseg,
           equal_scans=True)

    sp_mesh = make_mesh(4, batch_axis=1)
    mdri = tall.shape[1] // mode.mcu_height // 4 * mcu_cols
    got, mos_s = wall(lambda: encode_mosaic(
        tall[0], quality=75, subsampling="420", mesh=sp_mesh))
    require_same_bytes("mesh mosaic", got,
                       encode(tall[0], quality=75, subsampling="420",
                              restart_interval=mdri))
    report("mesh_mosaic", shape=tall[0].shape, mesh="1x4",
           equal_to_single=True,
           seconds=mos_s)


# ---------------------------------------------------------------------------


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-GPU sharded path")
    args = ap.parse_args(argv)

    import jax

    if jax.default_backend() != "gpu":
        print(f"no GPU: JAX backend is {jax.default_backend()!r}",
              file=sys.stderr)
        return 2
    cache = use_compile_cache()
    devs = jax.devices()
    print(f"devices: {len(devs)} x {devs[0].device_kind}; compile cache "
          f"{cache}", flush=True)
    t0 = time.perf_counter()
    if args.four:
        run_four_cards()
    else:
        run_one_card()
    print(f"all phases passed in {time.perf_counter() - t0:.1f} s")
    print(f"card: {card_line()}")
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
