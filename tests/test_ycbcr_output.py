"""decode(output="ycbcr") + finish_ycbcr == decode(output="rgb"), bitwise.

The ycbcr output returns the per-component uint8 sample planes (padded
block grids) and finish_ycbcr reproduces the device RGB finish on the host
— the transfer-halving serving path. Exactness
argument: integer samples make the triangular weights exact
quarter-integers, and each color channel is the same f32 expression the
device evaluates; these tests pin it across subsamplings, odd geometry,
scaled decode, extreme quantization and both entropy layouts.
"""

import numpy as np
import pytest

import jpeg_tpu
from jpeg_tpu import decode, encode, finish_ycbcr


@pytest.mark.parametrize("sub", ["444", "422", "420"])
@pytest.mark.parametrize("shape", [(64, 96), (61, 67)])
def test_ycbcr_matches_rgb(photo, sub, shape):
    img = photo[: shape[0], : shape[1]]
    jpg = encode(img, quality=80, subsampling=sub)
    rgb = decode(jpg)
    planes = decode(jpg, output="ycbcr")
    assert all(p.dtype == np.uint8 for p in planes.planes)
    got = finish_ycbcr(planes)
    np.testing.assert_array_equal(got, rgb)
    # The transfer win this path exists for: plane bytes < RGB bytes
    # whenever chroma is subsampled.
    if sub != "444":
        assert sum(p.nbytes for p in planes.planes) < rgb.nbytes


def test_ycbcr_nearest_upsample(photo):
    jpg = encode(photo[:40, :56], quality=85, subsampling="420")
    rgb = decode(jpg, fancy_upsample=False)
    got = finish_ycbcr(decode(jpg, output="ycbcr", fancy_upsample=False))
    np.testing.assert_array_equal(got, rgb)


@pytest.mark.parametrize("sd", [2, 8])
def test_ycbcr_scaled(photo, sd):
    jpg = encode(photo, quality=75, subsampling="420")
    rgb = decode(jpg, scale_denom=sd)
    got = finish_ycbcr(decode(jpg, output="ycbcr", scale_denom=sd))
    np.testing.assert_array_equal(got, rgb)


def test_ycbcr_extreme_quant(photo):
    # q=1 drives samples far out of range pre-clip — the range_limit
    # ordering case the RGB path handles; planes must round-trip it too.
    jpg = encode(photo[:48, :48], quality=1, subsampling="420")
    np.testing.assert_array_equal(
        finish_ycbcr(decode(jpg, output="ycbcr")), decode(jpg))


def test_ycbcr_entropy_backends(photo):
    jpg = encode(photo[:32, :48], quality=80, subsampling="422")
    base = decode(jpg)
    for entropy in ("numpy", "sparse"):
        got = finish_ycbcr(decode(jpg, output="ycbcr", entropy=entropy))
        np.testing.assert_array_equal(got, base)


def test_ycbcr_threaded_finish_tall_image(photo):
    """The threaded stripe path only engages above 256 output rows — the
    photo fixture is 240, so without this tall case the halo-exactness
    invariant ('thread count never changes bytes') went untested (r5
    review finding)."""
    tall = np.tile(photo, (2, 1, 1))[:437]  # 437 rows, odd height
    for sub in ("420", "422"):
        jpg = encode(tall, quality=80, subsampling=sub)
        planes = decode(jpg, output="ycbcr")
        serial = finish_ycbcr(planes, threads=1)
        np.testing.assert_array_equal(serial, finish_ycbcr(planes, threads=4))
        np.testing.assert_array_equal(serial, decode(jpg))


def test_ycbcr_rejections(photo):
    gray = encode(photo[:32, :32, 0], quality=80)
    with pytest.raises(ValueError):
        decode(gray, output="ycbcr")
    jpg = encode(photo[:32, :32], quality=80)
    with pytest.raises(ValueError):
        decode(jpg, output="nope")
    assert isinstance(decode(jpg, output="ycbcr"), jpeg_tpu.YCbCrPlanes)
