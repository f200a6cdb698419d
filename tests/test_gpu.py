"""Checks that only an NVIDIA GPU can run: the exactness contract of the
encode/decode path on the card (see chip_smoke.py, which runs the same
checks at full size). They skip on CPU-only hosts; on a GPU host run them
with the CPU platform enabled too (the references run on the CPU device):

    JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu tests/test_gpu.py
"""

import numpy as np
import pytest

import chip_smoke
from jpeg_tpu import decode, encode, encode_batched, finish_ycbcr
from jpeg_tpu.utils import synth

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module")
def on_gpu():
    import jax

    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU (chip_smoke.py runs these checks "
                    "on the card)")


@pytest.fixture(scope="module")
def frame():
    return synth.photo(540, 960, seed=11)


@pytest.mark.parametrize("name, kw", chip_smoke.encode_variants(960))
def test_gpu_encode_equals_reference(on_gpu, frame, name, kw):
    src = np.ascontiguousarray(frame[..., 1]) if "gray" in name else frame
    chip_smoke.require_same_bytes(name, encode(src, **kw),
                                  chip_smoke.reference_encode(src, **kw))


def test_gpu_batched_equals_single(on_gpu, frame):
    frames = np.stack(chip_smoke.distinct_frames(frame, 4))
    assert encode_batched(frames, quality=75) == [
        encode(f, quality=75) for f in frames]


def test_gpu_decode_within_one_of_cpu(on_gpu, frame):
    jpg = encode(frame, quality=75)
    dmax, _ = chip_smoke.pixel_delta(decode(jpg), chip_smoke.decode_on_cpu(jpg))
    assert dmax <= 1


def test_gpu_ycbcr_finish_exact(on_gpu, frame):
    jpg = encode(frame, quality=75)
    np.testing.assert_array_equal(
        finish_ycbcr(decode(jpg, output="ycbcr")), decode(jpg))


def test_gpu_entropy_backends_identical(on_gpu, frame):
    streams = {name: encode(frame, **kw)
               for name, kw in chip_smoke.encode_variants(frame.shape[1])
               if name in ("q75_422", "q75_420_restart_row")}
    chip_smoke.phase_entropy_backends(streams)
