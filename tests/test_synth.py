"""The seeded photographic-like image generator the fixtures are made from."""

import numpy as np
import pytest

from jpeg_tpu.utils import synth


@pytest.mark.parametrize("shape", [(1, 1), (7, 13), (240, 320), (64, 17)])
def test_photo_shape_dtype_deterministic(shape):
    a = synth.photo(*shape, seed=5)
    assert a.shape == (*shape, 3) and a.dtype == np.uint8
    np.testing.assert_array_equal(a, synth.photo(*shape, seed=5))
    g = synth.photo(*shape, seed=5, gray=True)
    assert g.shape == shape and g.dtype == np.uint8


def test_photo_seeds_differ_and_span_the_range():
    a = synth.photo(120, 160, seed=0)
    b = synth.photo(120, 160, seed=1)
    assert np.mean(a != b) > 0.5
    assert a.min() < 40 and a.max() > 215  # shadows and highlights
    # Channels are correlated (a shared luminance field), as in a photo.
    r, g = a[..., 0].astype(np.float64), a[..., 1].astype(np.float64)
    assert np.corrcoef(r.ravel(), g.ravel())[0, 1] > 0.5


def test_photo_rejects_empty():
    with pytest.raises(ValueError):
        synth.photo(0, 5)
