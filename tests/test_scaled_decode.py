"""DCT-domain scaled decode (decode(scale_denom=2/4/8) — libjpeg "draft"
mode). PIL's draft() is the independent oracle: sizes must match exactly;
pixel agreement is bounded by libjpeg draft-mode internals: the fast
fixed-point reduced IDCT (jidctred.c) and a different chroma-reduction
geometry at subsampled scales (libjpeg varies per-component DCT_scaled_size;
we reconstruct every component at k points and upsample) — ~31-38 dB on
real content, >50 dB where the paths coincide (1/8 luma = exact DC).
"""

import io

import numpy as np
import pytest
from PIL import Image

from jpeg_tpu import decode, encode

from conftest import psnr


def _pil_draft(jpg, mode, w, h, denom):
    im = Image.open(io.BytesIO(jpg))
    im.draft(mode, (-(-w // denom), -(-h // denom)))
    return np.asarray(im.convert(mode))


@pytest.mark.parametrize("denom", [2, 4, 8])
@pytest.mark.parametrize("sub", [0, 2])
def test_color_matches_pil_draft(photo, denom, sub):
    buf = io.BytesIO()
    Image.fromarray(photo).save(buf, "JPEG", quality=85, subsampling=sub)
    jpg = buf.getvalue()
    h, w = photo.shape[:2]
    ours = decode(jpg, scale_denom=denom)
    pil = _pil_draft(jpg, "RGB", w, h, denom)
    assert ours.shape == pil.shape == (-(-h // denom), -(-w // denom), 3)
    assert psnr(ours, pil) > 30.0, psnr(ours, pil)


@pytest.mark.parametrize("denom", [2, 4, 8])
def test_gray_matches_pil_draft(photo, denom):
    buf = io.BytesIO()
    Image.fromarray(photo[..., 1]).save(buf, "JPEG", quality=85)
    jpg = buf.getvalue()
    h, w = photo.shape[:2]
    ours = decode(jpg, scale_denom=denom)
    pil = _pil_draft(jpg, "L", w, h, denom)
    assert ours.shape == pil.shape
    assert psnr(ours, pil) > 34.0


def test_own_stream_and_odd_sizes(rng):
    img = rng.integers(0, 256, (37, 51, 3)).astype(np.uint8)
    jpg = encode(img, quality=90, subsampling="420")
    out = decode(jpg, scale_denom=8)
    assert out.shape == (5, 7, 3)  # ceil(37/8), ceil(51/8)
    # 1/8 decode is each block's DC: close to an 8x8 box average.
    full = decode(jpg).astype(np.float64)
    box = full[: 4 * 8, : 6 * 8].reshape(4, 8, 6, 8, 3).mean(axis=(1, 3))
    assert psnr(out[:4, :6], box) > 30.0


def test_progressive_scaled(photo):
    buf = io.BytesIO()
    Image.fromarray(photo).save(buf, "JPEG", progressive=True, quality=85)
    jpg = buf.getvalue()
    h, w = photo.shape[:2]
    ours = decode(jpg, scale_denom=4)
    pil = _pil_draft(jpg, "RGB", w, h, 4)
    assert ours.shape == pil.shape
    assert psnr(ours, pil) > 30.0


def test_scaled_validation(photo, rng):
    jpg = encode(photo, quality=80)
    with pytest.raises(ValueError):
        decode(jpg, scale_denom=3)
    a = rng.integers(0, 256, (16, 16, 4)).astype(np.uint8)
    buf = io.BytesIO()
    Image.fromarray(a, "CMYK").save(buf, "JPEG")
    with pytest.raises(ValueError):  # 4-component scaled decode unsupported
        decode(buf.getvalue(), scale_denom=2)


def test_scaled_device_output(photo):
    jpg = encode(photo, quality=80, subsampling="420")
    out = decode(jpg, scale_denom=4, device_output=True)
    assert not isinstance(out, np.ndarray)
    assert np.asarray(out).shape == (60, 80, 3)
