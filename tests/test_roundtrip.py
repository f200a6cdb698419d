"""End-to-end encode/decode tests with Pillow (libjpeg) as independent oracle.

Covers BASELINE.json configs 1-3: small-image encode, quality sweeps with
4:4:4/4:2:2, and 4:2:0 + restart-interval round trips with PSNR checks — plus
decoding of foreign (PIL-produced) JPEGs.
"""

import io

import numpy as np
import pytest
from PIL import Image

from jpeg_tpu import decode, encode

from conftest import psnr


def _pil_decode(jpg: bytes) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(jpg)).convert("RGB"))


# ---------------------------------------------------------------------------
# Our encoder -> PIL decoder (container + bitstream correctness)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["444", "422", "420"])
@pytest.mark.parametrize("quality", [25, 50, 75, 95])
def test_encode_quality_sweep_pil(photo, mode, quality):
    jpg = encode(photo, quality=quality, subsampling=mode)
    out = _pil_decode(jpg)
    assert out.shape == photo.shape
    floor = {25: 24.0, 50: 27.0, 75: 29.0, 95: 33.0}[quality]
    assert psnr(out, photo) > floor


def test_quality_monotone_psnr(photo):
    values = [psnr(_pil_decode(encode(photo, quality=q, subsampling="420")), photo)
              for q in (25, 50, 75, 95)]
    assert values == sorted(values)


def test_size_decreases_with_subsampling(photo):
    sizes = [len(encode(photo, quality=75, subsampling=m)) for m in ("444", "422", "420")]
    assert sizes[0] > sizes[1] > sizes[2]


@pytest.mark.parametrize("mode", ["444", "422", "420"])
def test_restart_interval_pil(photo, mode):
    base = _pil_decode(encode(photo, quality=75, subsampling=mode))
    for r in (1, 3, 8):
        jpg = encode(photo, quality=75, subsampling=mode, restart_interval=r)
        np.testing.assert_array_equal(_pil_decode(jpg), base)


def test_optimized_tables_same_pixels_smaller_file(photo):
    a = encode(photo, quality=85, subsampling="420")
    b = encode(photo, quality=85, subsampling="420", optimize_tables=True)
    assert len(b) < len(a)
    np.testing.assert_array_equal(_pil_decode(a), _pil_decode(b))


@pytest.mark.parametrize(
    "shape", [(8, 8), (16, 16), (13, 17), (31, 9), (64, 48), (1, 1), (7, 100)]
)
def test_odd_sizes(shape):
    """The padded-geometry bug swamp the reference drowned in (SURVEY.md §7d).
    Smooth gradient content so PSNR measures geometry handling, not noise
    compressibility."""
    h, w = shape
    yy, xx = np.mgrid[0:h, 0:w]
    rgb = np.stack(
        [
            (xx * 255 / max(w - 1, 1)),
            (yy * 255 / max(h - 1, 1)),
            ((xx + yy) * 255 / max(h + w - 2, 1)),
        ],
        axis=-1,
    ).astype(np.uint8)
    for mode in ("444", "420"):
        jpg = encode(rgb, quality=90, subsampling=mode)
        out = _pil_decode(jpg)
        assert out.shape == rgb.shape
        ours = decode(jpg)
        assert ours.shape == rgb.shape
        if min(shape) >= 8:
            assert psnr(out, rgb) > 25.0
            assert psnr(ours, rgb) > 25.0


def test_cam_bmp_config1(photo_square):
    """BASELINE.json config 1: encode a small reference BMP at q=90, 4:4:4."""
    jpg = encode(photo_square, quality=90, subsampling="444")
    out = _pil_decode(jpg)
    assert psnr(out, photo_square) > 30.0


def test_grayscale(photo):
    g = photo[:, :, 1]
    jpg = encode(g, quality=85)
    pil = np.asarray(Image.open(io.BytesIO(jpg)).convert("L"))
    assert psnr(pil, g) > 30.0
    ours = decode(jpg)
    assert ours.shape == g.shape
    assert psnr(ours, pil) > 45.0


# ---------------------------------------------------------------------------
# Our decoder vs PIL's decoder on the same streams
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["444", "422", "420"])
def test_our_decoder_matches_pil_on_our_streams(photo, mode):
    jpg = encode(photo, quality=75, subsampling=mode, restart_interval=2)
    ours = decode(jpg)
    pil = _pil_decode(jpg)
    # Same spec-conformant stream; differences limited to IDCT rounding and
    # chroma upsampling choice (we use nearest, libjpeg uses fancy triangular).
    assert psnr(ours, pil) > 40.0  # fancy upsampling: ~51 dB on 420/422


@pytest.mark.parametrize("pil_mode", ["4:4:4", "4:2:2", "4:2:0"])
def test_decode_foreign_pil_jpeg(photo, pil_mode):
    buf = io.BytesIO()
    Image.fromarray(photo).save(buf, "JPEG", quality=80, subsampling=pil_mode)
    jpg = buf.getvalue()
    ours = decode(jpg)
    pil = _pil_decode(jpg)
    assert ours.shape == pil.shape
    assert psnr(ours, pil) > 40.0


def test_decode_foreign_progressive(photo):
    """Progressive (SOF2) streams decode via the Annex-G scan merger
    (entropy/progressive_np.py) and agree with PIL."""
    buf = io.BytesIO()
    Image.fromarray(photo).save(buf, "JPEG", quality=75, progressive=True)
    ours = decode(buf.getvalue())
    pil = np.asarray(Image.open(buf).convert("RGB"))
    assert ours.shape == pil.shape
    assert psnr(ours, pil) > 45.0


def test_decode_foreign_optimized_tables(photo):
    buf = io.BytesIO()
    Image.fromarray(photo).save(buf, "JPEG", quality=75, optimize=True,
                                subsampling="4:2:0")
    ours = decode(buf.getvalue())
    pil = _pil_decode(buf.getvalue())
    assert psnr(ours, pil) > 30.0


def test_decode_foreign_restart_markers(photo):
    buf = io.BytesIO()
    Image.fromarray(photo).save(buf, "JPEG", quality=75, restart_marker_blocks=4)
    data = buf.getvalue()
    from jpeg_tpu.io import jfif

    info = jfif.parse_jpeg(data)
    if info.restart_interval == 0:
        pytest.skip("PIL build ignored restart_marker_blocks")
    ours = decode(data)
    assert psnr(ours, _pil_decode(data)) > 30.0


# ---------------------------------------------------------------------------
# Self round-trip
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["444", "422", "420"])
def test_self_roundtrip(photo, mode):
    jpg = encode(photo, quality=90, subsampling=mode)
    out = decode(jpg)
    floor = {"444": 33.0, "422": 31.0, "420": 30.0}[mode]
    assert psnr(out, photo) > floor


def test_reencode_stability(photo):
    """Encode(decode(encode(x))) should not collapse (idempotence-ish)."""
    j1 = encode(photo, quality=90, subsampling="444")
    d1 = decode(j1)
    j2 = encode(d1, quality=90, subsampling="444")
    d2 = decode(j2)
    assert psnr(d2, d1) > 40.0


def test_custom_quant_tables(photo):
    """User-supplied quantization tables flow through encode and the DQT."""
    from jpeg_tpu.io import jfif

    qy = np.full((8, 8), 20, dtype=np.int32)
    qc = np.full((8, 8), 40, dtype=np.int32)
    jpg = encode(photo, subsampling="444", quant_tables=(qy, qc))
    info = jfif.parse_jpeg(jpg)
    np.testing.assert_array_equal(info.qtables[0], qy)
    np.testing.assert_array_equal(info.qtables[1], qc)
    out = _pil_decode(jpg)
    assert psnr(out, photo) > 28.0
    ours = decode(jpg)
    assert psnr(ours, out) > 40.0


def test_custom_quant_tables_gray(photo):
    qy = np.full((8, 8), 16, dtype=np.int32)
    jpg = encode(photo[:, :, 0], quant_tables=(qy, qy))
    from jpeg_tpu.io import jfif
    np.testing.assert_array_equal(jfif.parse_jpeg(jpg).qtables[0], qy)


def test_float_input_accepted(photo):
    as_float = photo.astype(np.float64) + 0.3
    a = encode(as_float, quality=80)
    b = encode(photo, quality=80)
    assert a == b  # rounds back to the same uint8 image


def test_decode_411_stream(photo):
    """4:1:1 luma sampling (h=4, v=1), produced by PIL if supported."""
    import io as _io
    from PIL import Image as _Image
    buf = _io.BytesIO()
    try:
        _Image.fromarray(photo).save(buf, "JPEG", quality=80,
                                     subsampling="4:1:1")
    except (ValueError, OSError):
        pytest.skip("PIL build lacks 4:1:1")
    jpg = buf.getvalue()
    ours = decode(jpg)
    pil = np.asarray(_Image.open(_io.BytesIO(jpg)).convert("RGB"))
    assert ours.shape == pil.shape
    assert psnr(ours, pil) > 33.0


def test_1080p_roundtrip_config3():
    """BASELINE config 3: 1080p 4:2:0 with restart intervals, PSNR check."""
    h, w = 1080, 1920
    yy, xx = np.mgrid[0:h, 0:w]
    rgb = np.stack([xx % 256, yy % 256, (xx // 8 + yy // 8) % 256], -1).astype(np.uint8)
    jpg = encode(rgb, quality=75, subsampling="420", restart_interval=120)
    out = decode(jpg)
    assert out.shape == rgb.shape
    assert psnr(out, rgb) > 27.0
    pil = _pil_decode(jpg)
    assert psnr(out, pil) > 40.0


def test_jit_disabled_golden_run(rng):
    """SURVEY §5 'race detection' analog: the eager (disable_jit) pipeline must
    produce byte-identical output to the compiled one."""
    import jax

    img = rng.integers(0, 256, size=(24, 32, 3)).astype(np.uint8)
    compiled = encode(img, quality=80, subsampling="420")
    with jax.disable_jit():
        eager = encode(img, quality=80, subsampling="420")
    assert compiled == eager


def test_encode_deterministic(photo):
    a = encode(photo, quality=75, subsampling="420")
    b = encode(photo, quality=75, subsampling="420")
    assert a == b
