"""Progressive (SOF2) decode: spectral selection + successive approximation.

PIL/libjpeg is the stream producer and the independent oracle (its standard
progressive script uses DC first+refine, AC first with EOB runs, and AC
refinement scans, always with optimized tables — exercising every scan kind
in entropy/progressive_np.py). Agreement is limited only by our float IDCT
vs libjpeg's fixed-point one, same as sequential streams (> 45 dB).
"""

import io

import numpy as np
import pytest
from PIL import Image

from jpeg_tpu.io import jfif
from jpeg_tpu.models.decoder import decode

from conftest import psnr


def _pil_progressive(img, **kw):
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "JPEG", progressive=True, **kw)
    return buf.getvalue()


@pytest.mark.parametrize("sub", [0, 1, 2])
@pytest.mark.parametrize("quality", [35, 75, 95])
def test_progressive_color_matches_pil(photo, sub, quality):
    jpg = _pil_progressive(photo, quality=quality, subsampling=sub)
    info = jfif.parse_jpeg(jpg)
    assert info.progressive and len(info.scans) > 3
    ours = decode(jpg)
    pil = np.asarray(Image.open(io.BytesIO(jpg)).convert("RGB"))
    assert ours.shape == pil.shape == photo.shape
    assert psnr(ours, pil) > 45.0, psnr(ours, pil)


def test_progressive_grayscale(photo):
    jpg = _pil_progressive(photo[..., 1], quality=80)
    ours = decode(jpg)
    pil = np.asarray(Image.open(io.BytesIO(jpg)).convert("L"))
    assert ours.shape == pil.shape
    assert psnr(ours, pil) > 45.0


@pytest.mark.parametrize("shape", [(8, 8), (17, 23), (64, 100)])
def test_progressive_odd_sizes(rng, shape):
    img = rng.integers(0, 256, (*shape, 3)).astype(np.uint8)
    jpg = _pil_progressive(img, quality=85, subsampling=2)
    ours = decode(jpg)
    pil = np.asarray(Image.open(io.BytesIO(jpg)).convert("RGB"))
    assert ours.shape == pil.shape
    # Pure-noise chroma at 4:2:0 maximizes upsample-filter divergence; the
    # 8x8 case sits at ~39 dB, real content (the color sweep above) at 45+.
    assert psnr(ours, pil) > 37.0, psnr(ours, pil)


@pytest.mark.parametrize("sub", [0, 2])
def test_native_backend_bit_identical(photo, sub):
    """The C++ scan walker and the Python BitReader produce identical grids
    on every scan kind of libjpeg's standard progressive script."""
    from jpeg_tpu.entropy import native, progressive_np

    if not native.available():
        pytest.skip("native runtime unavailable")
    jpg = _pil_progressive(photo, quality=80, subsampling=sub)
    info = jfif.parse_jpeg(jpg)
    g_nat = progressive_np.decode_progressive(info, backend="native")
    g_np = progressive_np.decode_progressive(info, backend="numpy")
    for a, b in zip(g_nat, g_np):
        np.testing.assert_array_equal(a, b)


def test_native_backend_restart_markers(photo):
    """Progressive stream with RSTn in every scan: segment split, predictor
    and EOB-run resets, threaded segment decode — still bit-identical and
    PIL-exact."""
    from jpeg_tpu.entropy import native, progressive_np

    buf = io.BytesIO()
    Image.fromarray(photo).save(
        buf, "JPEG", progressive=True, quality=80, restart_marker_rows=1
    )
    jpg = buf.getvalue()
    info = jfif.parse_jpeg(jpg)
    assert any(s.restart_interval for s in info.scans)
    if native.available():
        g_nat = progressive_np.decode_progressive(info, backend="native")
        g_np = progressive_np.decode_progressive(info, backend="numpy")
        for a, b in zip(g_nat, g_np):
            np.testing.assert_array_equal(a, b)
    ours = decode(jpg)
    pil = np.asarray(Image.open(io.BytesIO(jpg)).convert("RGB"))
    assert psnr(ours, pil) > 45.0


def test_progressive_grayscale_native_identity(photo):
    from jpeg_tpu.entropy import native, progressive_np

    if not native.available():
        pytest.skip("native runtime unavailable")
    jpg = _pil_progressive(photo[..., 0], quality=70)
    info = jfif.parse_jpeg(jpg)
    g_nat = progressive_np.decode_progressive(info, backend="native")
    g_np = progressive_np.decode_progressive(info, backend="numpy")
    np.testing.assert_array_equal(g_nat[0], g_np[0])


def test_progressive_truncated_raises(photo):
    jpg = _pil_progressive(photo, quality=75)
    for cut in (len(jpg) // 3, 2 * len(jpg) // 3):
        try:
            decode(jpg[:cut])
        except (jfif.JpegFormatError, ValueError):
            pass  # must raise or return cleanly, never crash/hang


def test_progressive_info_fields(photo):
    jpg = _pil_progressive(photo, quality=75)
    info = jfif.parse_jpeg(jpg)
    # First scan is DC-first over all components; later scans are per-band.
    s0 = info.scans[0]
    assert (s0.ss, s0.ah) == (0, 0) and s0.se == 0
    assert any(s.ss > 0 and s.ah == 0 for s in info.scans)  # AC first
    assert any(s.ah > 0 for s in info.scans)  # refinement passes
