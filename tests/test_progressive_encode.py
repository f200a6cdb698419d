"""Progressive (SOF2) encode: our writer, decoded by our reader AND PIL.

A progressive stream is a lossless re-coding of the
same quantized coefficients, so the exactness oracle is two-sided:
  * our decoder must produce IDENTICAL pixels for the progressive and
    baseline streams of the same image (same coefficients, same finish);
  * PIL (libjpeg) must also produce identical pixels for the two streams —
    which proves the progressive scan script re-codes the coefficients
    exactly, independent of our own reader.
Cross-decoder comparisons (PIL vs ours) use the same PSNR bound as the
rest of the suite (IDCT rounding differs between libjpeg's integer path
and our float path — tests/test_roundtrip.py convention).
"""

import io

import numpy as np
import pytest
from PIL import Image

from jpeg_tpu import decode, encode
from jpeg_tpu.models.progressive_enc import encode_progressive
from jpeg_tpu.utils.metrics import psnr


def _pil(data: bytes) -> np.ndarray:
    img = Image.open(io.BytesIO(data))
    img.load()
    if img.mode == "L":
        return np.asarray(img)
    return np.asarray(img.convert("RGB"))


def _check(img, prog: bytes, base: bytes):
    assert b"\xff\xc2" in prog[:200], "stream is not SOF2"
    np.testing.assert_array_equal(decode(prog), decode(base))
    np.testing.assert_array_equal(_pil(prog), _pil(base))
    assert psnr(_pil(prog), decode(prog)) > 40.0


@pytest.mark.parametrize("sub", ["444", "422", "420"])
def test_progressive_color_roundtrip(photo, sub):
    img = photo[:80, :112]
    _check(img, encode_progressive(img, quality=80, subsampling=sub),
           encode(img, quality=80, subsampling=sub))


def test_progressive_odd_geometry(photo):
    img = photo[:53, :61]
    _check(img, encode_progressive(img, quality=85, subsampling="420"),
           encode(img, quality=85, subsampling="420"))


@pytest.mark.parametrize("shape", [(42, 52), (16, 52), (42, 16), (9, 9)])
def test_progressive_mcu_padding_geometry(photo, shape):
    """Non-interleaved scans code only the component's ceil(size/8) block
    raster (spec A.2.2) — NOT the MCU-padded grid. A width that pads to an
    extra luma block column (e.g. 52 -> 64 at 4:2:0) desyncs every decoder
    if the padding blocks are emitted; fuzz found it, this pins it."""
    img = np.ascontiguousarray(photo[: shape[0], : shape[1]])
    _check(img, encode_progressive(img, quality=25, subsampling="420"),
           encode(img, quality=25, subsampling="420"))


def test_progressive_fuzz_geometry_quality(photo):
    rng = np.random.default_rng(7)
    for _ in range(8):
        h = int(rng.integers(8, 70))
        w = int(rng.integers(8, 70))
        q = int(rng.choice([1, 25, 75, 95]))
        sub = str(rng.choice(["444", "422", "420"]))
        img = np.ascontiguousarray(photo[:h, :w])
        _check(img, encode_progressive(img, quality=q, subsampling=sub),
               encode(img, quality=q, subsampling=sub))


def test_progressive_gray(photo):
    img = photo[:64, :64, 1]
    _check(img, encode_progressive(img, quality=75), encode(img, 75))


@pytest.mark.parametrize("quality", [1, 50, 95])
def test_progressive_quality_extremes(photo, quality):
    img = photo[:48, :64]
    _check(img, encode_progressive(img, quality=quality, subsampling="420"),
           encode(img, quality, subsampling="420"))


def test_progressive_full_image(photo):
    _check(photo, encode_progressive(photo, quality=75, subsampling="420"),
           encode(photo, quality=75, subsampling="420"))


def test_progressive_custom_script(photo):
    # A script without successive approximation: DC then full AC bands.
    img = photo[:64, :64]
    script = (
        ((0, 1, 2), 0, 0, 0, 0),
        ((0,), 1, 63, 0, 0),
        ((1,), 1, 63, 0, 0),
        ((2,), 1, 63, 0, 0),
    )
    _check(img,
           encode_progressive(img, quality=80, subsampling="444",
                              scans=script),
           encode(img, 80, subsampling="444"))


def test_progressive_invalid_scripts(photo):
    img = photo[:32, :32]
    with pytest.raises(ValueError):
        encode_progressive(img, scans=(((0, 1), 1, 63, 0, 0),))  # multi-comp AC
    with pytest.raises(ValueError):
        encode_progressive(img, scans=(((0,), 0, 5, 0, 0),))  # DC with Se>0


def test_cli_progressive_encode(tmp_path, photo):
    import os
    import subprocess
    import sys

    from jpeg_tpu.io import bmp as bmp_io

    src = tmp_path / "t.bmp"
    src.write_bytes(bmp_io.encode_bmp(photo[:48, :64]))
    out = tmp_path / "t.jpg"
    env = dict(os.environ, PYTHONPATH=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    p = subprocess.run(
        [sys.executable, "-m", "jpeg_tpu", "encode", str(src), str(out),
         "--progressive", "-q", "80"],
        capture_output=True, text=True, env=env, timeout=180,
    )
    assert p.returncode == 0, p.stderr[-1500:]
    data = out.read_bytes()
    assert b"\xff\xc2" in data[:200]
    np.testing.assert_array_equal(
        _pil(data), _pil(encode(photo[:48, :64], 80, subsampling="420")))


def test_progressive_size_sane(photo):
    # Per-scan optimal tables generally compress at least comparably to
    # baseline with standard tables.
    img = photo[:160, :240]
    prog = encode_progressive(img, quality=75, subsampling="420")
    base = encode(img, quality=75, subsampling="420")
    assert len(prog) < int(len(base) * 1.25)
