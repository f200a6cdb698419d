"""Exact fixed-point transform (ops/mcu_conv._mcu_transform_int).

The accelerator default: coefficients must be bit-identical to an int64
NumPy emulation of the fixed-point math (no float rounding anywhere in the
value path), agree with the staged f32 transform except at exact rounding
boundaries, and be invariant under vmap/batching — the property that keeps
every executable's bytes identical.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from jpeg_tpu.config import Subsampling
from jpeg_tpu.ops import mcu_conv


def _int_transform_numpy(rgb, qy, qc, mode):
    """int64 host emulation of the fixed-point transform: the ground truth
    the XLA program must match EXACTLY."""
    k_hilo, bias_int = mcu_conv.mcu_kernel_int(mode)
    nco = bias_int.shape[0]
    k_int = (
        k_hilo[..., :nco].astype(np.int64) * (1 << mcu_conv._HI_SHIFT)
        + k_hilo[..., nco:].astype(np.int64)
    )
    mh, mw = mode.mcu_height, mode.mcu_width
    H, W, _ = rgb.shape
    R, C = H // mh, W // mw
    patches = (
        rgb.reshape(R, mh, C, mw, 3).transpose(0, 2, 1, 3, 4)
        .reshape(R * C, mh * mw * 3).astype(np.int64)
    )
    acc = patches @ k_int.reshape(-1, nco) + bias_int.astype(np.int64)
    hv = mode.h_factor * mode.v_factor
    from jpeg_tpu import tables

    order = np.asarray(tables.ZIGZAG_ORDER)
    qzy = qy.reshape(64)[order].astype(np.int64)
    qzc = qc.reshape(64)[order].astype(np.int64)
    d = np.concatenate([np.tile(qzy, hv), qzc, qzc]) << mcu_conv._INT_SCALE_BITS
    q0 = (2 * np.abs(acc) + d) // (2 * d)
    return np.where(acc < 0, -q0, q0).astype(np.int32).reshape(-1, hv + 2, 64)


@pytest.mark.parametrize("mode", list(Subsampling))
def test_int_transform_matches_int64_emulation(rng, mode):
    """The XLA fixed-point program, run on the CPU device, is bit-exact vs
    pure-int64 host math for every subsampling: the bf16 hi/lo matmul with
    f32 accumulation loses nothing (bounds asserted in mcu_kernel_int)."""
    h = mode.mcu_height * 3
    w = mode.mcu_width * 2
    rgb = rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
    qy = np.asarray(
        np.clip(rng.integers(1, 100, (8, 8)), 1, 255), np.int32)
    qc = np.asarray(
        np.clip(rng.integers(1, 100, (8, 8)), 1, 255), np.int32)
    got = np.asarray(jax.jit(
        lambda x, a, b: mcu_conv._mcu_transform_int(x, a, b, mode)
    )(rgb, jnp.asarray(qy), jnp.asarray(qc)))
    want = _int_transform_numpy(rgb, qy, qc, mode)
    np.testing.assert_array_equal(got, want)


def test_int_transform_close_to_staged(rng, quality_tables):
    """Fixed-point vs staged f32: quantized coefficients agree except at
    exact rounding boundaries, and then by at most 1."""
    mode = Subsampling.YUV420
    rgb = rng.integers(0, 256, (48, 64, 3)).astype(np.uint8)
    qy, qc = quality_tables
    a = np.asarray(jax.jit(
        lambda x, t1, t2: mcu_conv._mcu_transform_int(x, t1, t2, mode)
    )(rgb, qy, qc))
    b = np.asarray(jax.jit(
        lambda x, t1, t2: mcu_conv._mcu_transform_staged(x, t1, t2, mode)
    )(rgb, qy, qc))
    diff = np.abs(a.astype(np.int64) - b.astype(np.int64))
    assert diff.max() <= 1
    assert (diff != 0).mean() < 0.01


def test_int_transform_batched_matches_single(rng):
    """vmap of the fixed-point transform is bit-identical to per-image calls
    under jit — the invariant a float conv cannot give."""
    mode = Subsampling.YUV420
    imgs = rng.integers(0, 256, (3, 32, 32, 3)).astype(np.uint8)
    qy = jnp.asarray(np.full((8, 8), 17, np.int32))
    qc = jnp.asarray(np.full((8, 8), 29, np.int32))
    single = jax.jit(
        lambda x, a, b: mcu_conv._mcu_transform_int(x, a, b, mode))
    batched = jax.jit(jax.vmap(
        lambda x, a, b: mcu_conv._mcu_transform_int(x, a, b, mode),
        in_axes=(0, None, None)))
    wb = np.asarray(batched(jnp.asarray(imgs), qy, qc))
    for i in range(imgs.shape[0]):
        np.testing.assert_array_equal(
            wb[i], np.asarray(single(jnp.asarray(imgs[i]), qy, qc)))


@pytest.fixture
def quality_tables():
    from jpeg_tpu.ops import quant

    return jnp.asarray(quant.luma_table(75)), jnp.asarray(quant.chroma_table(75))


def test_gray_int_transform_matches_int64_emulation(rng):
    """gray_transform_int is bit-exact vs pure-int64 host math and within
    +-1 of the staged f32 path."""
    from jpeg_tpu.models import encoder as E

    plane = rng.integers(0, 256, (40, 56)).astype(np.uint8)
    qy = np.clip(rng.integers(1, 120, (8, 8)), 1, 255).astype(np.int32)
    got = np.asarray(jax.jit(mcu_conv.gray_transform_int)(
        plane, jnp.asarray(qy)))

    k_hilo, bias_int = mcu_conv.gray_kernel_int()
    k_int = (k_hilo[:, :64].astype(np.int64) * (1 << mcu_conv._HI_SHIFT)
             + k_hilo[:, 64:].astype(np.int64))
    blocks = (plane.reshape(5, 8, 7, 8).transpose(0, 2, 1, 3)
              .reshape(-1, 64).astype(np.int64))
    acc = blocks @ k_int + bias_int.astype(np.int64)
    from jpeg_tpu import tables

    d = (qy.reshape(64)[np.asarray(tables.ZIGZAG_ORDER)].astype(np.int64)
         << mcu_conv._INT_SCALE_BITS)
    q0 = (2 * np.abs(acc) + d) // (2 * d)
    want = np.where(acc < 0, -q0, q0).astype(np.int32)
    np.testing.assert_array_equal(got, want)

    staged = np.asarray(jax.jit(
        lambda p, q: E._plane_zz(p.astype(jnp.float32) - 128.0, q)
    )(plane, jnp.asarray(qy)))
    diff = np.abs(got.astype(np.int64) - staged.astype(np.int64))
    assert diff.max() <= 1 and (diff != 0).mean() < 0.01
