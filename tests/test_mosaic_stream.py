"""Streaming gigapixel mosaic encode (BASELINE config 5
"gigapixel mosaic" at contract scale).

encode_mosaic_stream never materializes the image: the source callable is
driven stripe by stripe and stripes splice at byte-aligned RSTn boundaries,
so the output is byte-identical to the whole-image encoder at the same DRI.
The >=0.5 GPix case runs in a subprocess so its peak RSS is measured in
isolation (the bound proves streaming: the raw image alone is ~1.6 GB).
"""

import io
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
from PIL import Image

from jpeg_tpu import decode, encode
from jpeg_tpu.config import Subsampling
from jpeg_tpu.parallel.mosaic import encode_mosaic_stream

from conftest import psnr


@pytest.mark.parametrize("sub,rst_rows", [("420", 1), ("444", 2), ("422", 1)])
def test_stream_matches_whole_image_encode(rng, sub, rst_rows):
    h, w = 167, 230  # odd: bottom/right edge padding on the last stripe
    img = rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
    mode = Subsampling(sub)
    r = rst_rows * (-(-w // mode.mcu_width))
    ref = encode(img, quality=80, subsampling=sub, restart_interval=r)
    got = encode_mosaic_stream(
        lambda a, b: img[a:b], h, w, quality=80, subsampling=sub,
        stripe_rows=mode.mcu_height * rst_rows * 2, rst_rows=rst_rows,
    )
    assert got == ref


def test_stream_optimized_tables_two_pass(rng):
    h, w = 96, 160
    img = rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
    r = w // 16
    ref = encode(img, quality=85, subsampling="420", restart_interval=r,
                 optimize_tables=True)
    calls = []

    def source(a, b):
        calls.append((a, b))
        return img[a:b]

    got = encode_mosaic_stream(source, h, w, quality=85, subsampling="420",
                               stripe_rows=32, optimize_tables=True)
    assert got == ref
    # Two passes over the stripes: histogram pass + pack pass.
    assert len(calls) == 2 * len(set(calls))


def test_stream_file_sink_and_decode(rng, tmp_path):
    h, w = 130, 96
    img = rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
    path = tmp_path / "m.jpg"
    with open(path, "wb") as f:
        assert encode_mosaic_stream(
            lambda a, b: img[a:b], h, w, quality=90, out=f) is None
    data = path.read_bytes()
    ours = decode(data)
    pil = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
    assert ours.shape == (h, w, 3)
    assert psnr(ours, pil) > 40.0  # PIL is the oracle (noise at 4:2:0 is
    # far from the source by construction; agreement with libjpeg is the bar)


def test_stream_validates_arguments(rng):
    img = rng.integers(0, 256, (32, 32, 3)).astype(np.uint8)
    with pytest.raises(ValueError):
        encode_mosaic_stream(lambda a, b: img[a:b], 0, 32)
    with pytest.raises(ValueError):  # DRI field overflow
        encode_mosaic_stream(lambda a, b: img[a:b], 32, 16 * 70000)
    with pytest.raises(ValueError):  # wrong source shape
        encode_mosaic_stream(lambda a, b: img[a:b, :16], 32, 32)


GIGAPIXEL_SCRIPT = textwrap.dedent("""
    import json, sys, time

    def rss():
        # NOT ru_maxrss: on Linux it is inherited across fork and survives
        # execve, so a subprocess spawned by a fat pytest parent reports the
        # PARENT's high-water (observed: "1.8 GB" before a byte of work).
        # VmHWM belongs to this process's own mm and resets on exec.
        for line in open("/proc/self/status"):
            if line.startswith("VmHWM"):
                return int(line.split()[1]) / 1e6  # kB -> GB
        raise RuntimeError("no VmHWM")

    import numpy as np
    import jax; jax.config.update("jax_platforms", "cpu")
    from jpeg_tpu.io import jfif
    from jpeg_tpu.parallel.mosaic import encode_mosaic_stream

    checkpoints = {"imports": rss(), "devices": len(jax.devices())}

    H, W = 32768, 16384  # 0.537 GPix = 16x (4K tile area), raw ~1.6 GB
    def source(r0, r1):
        yy = np.arange(r0, r1, dtype=np.uint32)[:, None]
        xx = np.arange(W, dtype=np.uint32)[None, :]
        z = np.zeros((r1 - r0, W), np.uint32)
        return np.stack([(xx * 255 // W + z).astype(np.uint8),
                         (yy * 255 // H + z).astype(np.uint8),
                         ((xx + yy) * 127 // (H + W)).astype(np.uint8)], -1)

    nstripes = [0]

    def src_logged(r0, r1):
        nstripes[0] += 1
        if nstripes[0] in (1, 2, 8):
            checkpoints[f"stripe{nstripes[0]}"] = rss()
        return source(r0, r1)

    t0 = time.time()
    with open(sys.argv[1], "wb") as f:
        # 336 rows = ~16 MB stripes: keeps nominal RSS ~0.7 GB so even 2x
        # allocator noise under full-suite load stays far below the bound.
        encode_mosaic_stream(src_logged, H, W, quality=75, stripe_rows=336,
                             out=f)
    info = jfif.parse_jpeg(open(sys.argv[1], "rb").read())
    print(json.dumps({
        "mpix": H * W / 1e6, "s": time.time() - t0, "rss_gb": rss(),
        "w": info.width, "h": info.height, "dri": info.restart_interval,
        "checkpoints": checkpoints,
    }))
""")


def test_gigapixel_stream_bounded_rss(tmp_path):
    """>=0.5 GPix single-JFIF encode: peak RSS must stay far below the raw
    image (1.6 GB), proving stripes stream; the result must parse and be
    PIL-decodable (draft mode keeps the oracle's RAM sane too)."""
    out = tmp_path / "giga.jpg"
    script = tmp_path / "giga.py"
    script.write_text(GIGAPIXEL_SCRIPT)
    env = dict(os.environ, PYTHONPATH=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    # conftest exports an 8-virtual-device XLA_FLAGS for the sharding tests;
    # 8 CPU "devices" octuple some XLA arenas and would distort the RSS bound.
    env.pop("XLA_FLAGS", None)
    proc = subprocess.run(
        [sys.executable, str(script), str(out)], capture_output=True,
        text=True, timeout=600, env=env,
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    import json

    stats = json.loads(proc.stdout.strip().splitlines()[-1])
    assert stats["mpix"] >= 500, stats
    assert (stats["w"], stats["h"]) == (16384, 32768), stats
    assert stats["dri"] > 0, stats
    # Raw pixels alone are 1.61 GB; staying under 1.45 proves streaming
    # (measured ~1.1 GB; headroom for allocator noise under suite load).
    assert stats["rss_gb"] < 1.45, f"peak RSS {stats['rss_gb']:.2f} GB: {stats}"

    old_max = Image.MAX_IMAGE_PIXELS
    Image.MAX_IMAGE_PIXELS = None  # 537 MPix > PIL's decompression-bomb gate
    try:
        pil = Image.open(out)
        assert pil.size == (16384, 32768)
        pil.draft("RGB", (16384 // 8, 32768 // 8))  # 1/8 DCT-scaled decode
        arr = np.asarray(pil.convert("RGB"))
        assert arr.shape[0] >= 4096 and arr.std() > 10  # real content
    finally:
        Image.MAX_IMAGE_PIXELS = old_max
