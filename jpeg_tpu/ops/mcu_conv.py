"""The whole encoder transform as ONE stride-MCU convolution.

Color conversion, the -128 level shift, chroma box subsampling, the 2-D DCT
and the zig-zag permutation are all linear (or affine) maps from the MCU's
RGB pixels to its (hv + 2) x 64 zig-zag coefficients — so they compose into a
single (mcu_h, mcu_w, 3, (hv+2)*64) convolution kernel applied with stride
(mcu_h, mcu_w). Since the stride equals the window, it is one im2col reshape
plus one GEMM; the output arrives already MCU-interleaved AND in scan order,
so the transform needs no gathers and no intermediate planes.

Only quantization stays outside the kernel (tables are runtime arguments, so
one compiled program serves every quality). Replaces the reference's five
separate passes (`preprocess.c` color/shift, `downsample.c` stubs, `dct.c`
per-block loops, `zig_zag.c`) with one matrix product.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from jpeg_tpu.config import Subsampling

_PRECISION = jax.lax.Precision.HIGHEST
# The exact transform's matmul contract, stated to the compiler rather than
# left to each backend's default: bfloat16 operands (integers <= 256 are exact
# in bf16, so the products are exact) accumulated in float32 with imprecise
# accumulation disallowed. Every partial sum stays below 2^24 (asserted in
# mcu_kernel_int), so the float32 sums are exact in any order — on CPU, on a
# GPU's tensor cores, under any XLA fusion.
_EXACT_DOT = jax.lax.DotAlgorithmPreset.BF16_BF16_F32


@functools.cache
def _mcu_kernel_f64(mode: Subsampling) -> tuple[np.ndarray, np.ndarray]:
    """Composed transform kernel in float64:
    (kernel (mcu_h, mcu_w, 3, (hv+2)*64), bias ((hv+2)*64,)).

    Output channel blk*64 + k is zig-zag DCT coefficient k of MCU block blk:
    blocks 0..hv-1 are luma in v-by-h raster order (spec A.2.3), then Cb, Cr.
    The bias folds the -128 level shift: it only touches DC rows (the other
    DCT rows sum to zero), and the chroma matrix rows' +128 storage offset
    cancels the shift exactly, leaving luma DC at -1024 and chroma DC at 0.
    """
    from jpeg_tpu import tables
    from jpeg_tpu.ops import color, dct

    hf, vf = mode.h_factor, mode.v_factor
    hv = hf * vf
    mh, mw = mode.mcu_height, mode.mcu_width
    d8 = dct.dct_basis().astype(np.float64)
    zz = np.kron(d8, d8)[np.asarray(tables.ZIGZAG_ORDER)]  # (64, 64)
    w = zz.reshape(64, 8, 8)  # (k, u, v)
    cw = color.RGB_TO_YCBCR.astype(np.float64)

    kern = np.zeros((mh, mw, 3, (hv + 2) * 64), dtype=np.float64)
    for a in range(vf):
        for b in range(hf):
            blk = a * hf + b
            kern[8 * a:8 * a + 8, 8 * b:8 * b + 8, :, 64 * blk:64 * blk + 64] = (
                np.einsum("kuv,c->uvck", w, cw[0])
            )
    # Chroma: the box mean spreads each subsampled tap over its vf x hf
    # source pixels with weight 1/(vf*hf).
    inv = 1.0 / (vf * hf)
    for ci, row in ((hv, cw[1]), (hv + 1, cw[2])):
        full = np.einsum("kuv,c->uvck", w, row)  # on the subsampled grid
        up = np.repeat(np.repeat(full, vf, axis=0), hf, axis=1) * inv
        kern[:, :, :, 64 * ci:64 * ci + 64] = up

    bias = np.zeros((hv + 2) * 64, dtype=np.float64)
    for blk in range(hv):
        bias[64 * blk] = -1024.0  # luma DC level shift: -(128 * 64) / 8
    return kern, bias


@functools.cache
def mcu_kernel(mode: Subsampling) -> tuple[np.ndarray, np.ndarray]:
    """f32 rounding of _mcu_kernel_f64 (the float conv kernel)."""
    kern, bias = _mcu_kernel_f64(mode)
    return kern.astype(np.float32), bias.astype(np.float32)


# Fixed-point scale of the integer transform kernel. At 2^15 the composed
# kernel's rounding perturbs a coefficient by well under 0.15 pre-quantization
# (sum_i |eps_i|*255 with |eps_i| <= 2^-16), so quantized outputs match the
# float path except at exact rounding boundaries — and, unlike the float
# path, they are BIT-EXACT under any XLA fusion.
_INT_SCALE_BITS = 15
# Kernel split K_int = K_hi * 2^_HI_SHIFT + K_lo with |K_hi| <= 256,
# |K_lo| <= 2^(_HI_SHIFT-1): both halves and all uint8 pixels are exact in
# bfloat16 (integers up to 256), so a bf16 matmul with an f32 accumulator
# (_EXACT_DOT) computes both dot products exactly (all partial sums < 2^24).
_HI_SHIFT = 7


@functools.cache
def mcu_kernel_int(mode: Subsampling):
    """Integer fixed-point twin of mcu_kernel for the exact transform:
    (k_hilo (mcu_h, mcu_w, 3, 2*(hv+2)*64) f32-storing-integers,
     bias_int ((hv+2)*64,) int32).

    k_hilo stacks the hi kernel then the lo kernel along output channels so
    ONE conv produces both partial sums; the true coefficient is
    (acc_hi * 2^_HI_SHIFT + acc_lo + bias_int) / 2^_INT_SCALE_BITS.
    Exactness bounds are asserted here at build time, not assumed."""
    kern64, bias64 = _mcu_kernel_f64(mode)
    k_int = np.rint(kern64 * (1 << _INT_SCALE_BITS))
    k_hi = np.rint(k_int / (1 << _HI_SHIFT))
    k_lo = k_int - k_hi * (1 << _HI_SHIFT)
    assert np.abs(k_hi).max() <= 256 and np.abs(k_lo).max() <= 1 << (
        _HI_SHIFT - 1
    )
    # f32-accumulator exactness: every partial sum of |pixel * weight| must
    # stay below 2^24 per output channel.
    nco = kern64.shape[-1]
    for half in (k_hi, k_lo):
        worst = np.abs(half).reshape(-1, nco).sum(axis=0).max() * 255.0
        assert worst < 2 ** 24, worst
    bias_int = np.rint(bias64 * (1 << _INT_SCALE_BITS)).astype(np.int32)
    k_hilo = np.concatenate([k_hi, k_lo], axis=-1).astype(np.float32)
    return k_hilo, bias_int


def zigzag_qdiv(qy, qc, hv: int):
    """((hv+2)*64,) f32 per-channel quantization divisors from the runtime
    (8, 8) tables (zig-zag order, luma channels first)."""
    from jpeg_tpu import tables

    order = jnp.asarray(tables.ZIGZAG_ORDER)
    qzy = qy.reshape(64)[order].astype(jnp.float32)
    qzc = qc.reshape(64)[order].astype(jnp.float32)
    return jnp.concatenate([jnp.tile(qzy, hv), qzc, qzc])


def _mcu_transform_staged(rgb, qy, qc, mode: Subsampling):
    """CPU form of mcu_transform: elementwise color + box downsample +
    per-plane (64, 64) zig-zag-DCT matmuls. Same output contract; ~10x fewer
    FLOPs than the one-matmul form, which only pays off where matrix units
    sit idle. Platform-local byte stability: every encode path on a given
    backend routes through the same branch."""
    from jpeg_tpu import tables
    from jpeg_tpu.ops import color, dct, quant, subsample, tile

    hf, vf = mode.h_factor, mode.v_factor
    hv = hf * vf
    n_mcu = (rgb.shape[0] // mode.mcu_height) * (rgb.shape[1] // mode.mcu_width)
    y, cb, cr = color.rgb_to_ycbcr_planes(rgb)
    y = y - 128.0
    cb = subsample.downsample_plane(cb - 128.0, mode)
    cr = subsample.downsample_plane(cr - 128.0, mode)
    order = jnp.asarray(tables.ZIGZAG_ORDER)

    def pz(p, qtab, v=1, hh=1):
        qz = qtab.reshape(64)[order].astype(jnp.float32)
        flat = tile.blocks_scan_order(p, v, hh)
        zzc = dct.fdct_zigzag_blocks(flat)
        return quant.round_half_away(zzc / qz).astype(jnp.int32)

    y_scan = pz(y, qy, vf, hf).reshape(n_mcu, hv, 64)
    cb_zz = pz(cb, qc)
    cr_zz = pz(cr, qc)
    return jnp.concatenate([y_scan, cb_zz[:, None], cr_zz[:, None]], axis=1)


def zigzag_qdiv_int(qy, qc, hv: int):
    """((hv+2)*64,) int32 per-channel quantization divisors (zig-zag order),
    the integer twin of zigzag_qdiv."""
    from jpeg_tpu import tables

    order = jnp.asarray(tables.ZIGZAG_ORDER)
    qzy = qy.reshape(64)[order].astype(jnp.int32)
    qzc = qc.reshape(64)[order].astype(jnp.int32)
    return jnp.concatenate([jnp.tile(qzy, hv), qzc, qzc])


def _mcu_transform_int(rgb, qy, qc, mode: Subsampling):
    """Exact fixed-point transform (the accelerator path): explicit im2col
    (one reshape+transpose — stride == window, so patches don't overlap) +
    ONE bf16 matmul with doubled output columns
    computing the hi/lo integer partial sums exactly (every product and
    partial sum < 2^24 in the f32 accumulator — bounds asserted in
    mcu_kernel_int), then integer combine and exact spec rounding. No value
    ever depends on float rounding order, so every executable — single,
    vmapped/batched, sharded, any XLA fusion — produces bit-identical
    coefficients.

    Quantization round_half_away(c / (q * 2^S)) is exact integer arithmetic:
    sign * ((2|c| + d) // (2d)) with d = q << S; all magnitudes < 2^28.
    Anchors the reference's per-block float loops (dct.c:36-59,
    quantise.c:21-41) in libjpeg-islow-style scaled-integer form."""
    k_hilo_np, bias_np = mcu_kernel_int(mode)
    kern = jnp.asarray(
        k_hilo_np.reshape(-1, k_hilo_np.shape[-1])
    ).astype(jnp.bfloat16)
    bias = jnp.asarray(bias_np)
    hv = mode.h_factor * mode.v_factor
    nco = (hv + 2) * 64
    mh, mw = mode.mcu_height, mode.mcu_width
    r, c = rgb.shape[0] // mh, rgb.shape[1] // mw
    # Explicit im2col (stride == window, so patches don't overlap: one
    # reshape+transpose) + ONE plain matmul.
    patches = rgb.reshape(r, mh, c, mw * 3).transpose(0, 2, 1, 3).reshape(
        r * c, mh * mw * 3)
    out = jax.lax.dot_general(
        patches.astype(jnp.bfloat16), kern, (((1,), (0,)), ((), ())),
        precision=_EXACT_DOT, preferred_element_type=jnp.float32,
    )
    acc = (
        out[:, :nco].astype(jnp.int32) * (1 << _HI_SHIFT)
        + out[:, nco:].astype(jnp.int32)
        + bias
    )
    d = zigzag_qdiv_int(qy, qc, hv) << _INT_SCALE_BITS
    q0 = (2 * jnp.abs(acc) + d) // (2 * d)
    q = jnp.where(acc < 0, -q0, q0)
    return q.reshape(-1, hv + 2, 64)


@functools.cache
def gray_kernel_int():
    """Integer fixed-point kernel for the single-plane (gray) transform:
    (k_hilo (64, 128) f32-storing-integers, bias_int (64,) int32). Same
    scale/split/exactness contract as mcu_kernel_int; the -128 level shift
    folds into the DC bias (-1024 * 2^S)."""
    from jpeg_tpu import tables
    from jpeg_tpu.ops import dct

    d8 = dct.dct_basis().astype(np.float64)
    zz = np.kron(d8, d8)[np.asarray(tables.ZIGZAG_ORDER)]  # (64k, 64px)
    k_int = np.rint(zz.T * (1 << _INT_SCALE_BITS))  # (px, k)
    k_hi = np.rint(k_int / (1 << _HI_SHIFT))
    k_lo = k_int - k_hi * (1 << _HI_SHIFT)
    assert np.abs(k_hi).max() <= 256 and np.abs(k_lo).max() <= 1 << (
        _HI_SHIFT - 1
    )
    for half in (k_hi, k_lo):
        assert np.abs(half).sum(axis=0).max() * 255.0 < 2 ** 24
    bias = np.zeros(64, dtype=np.float64)
    bias[0] = -1024.0 * (1 << _INT_SCALE_BITS)
    return (np.concatenate([k_hi, k_lo], axis=1).astype(np.float32),
            np.rint(bias).astype(np.int32))


def gray_transform_int(plane, qy):
    """(H, W) uint8 8-aligned -> (B, 64) int32 quantized zig-zag blocks,
    exact fixed-point (the gray twin of _mcu_transform_int: same
    bit-identical-across-executables guarantee)."""
    from jpeg_tpu.ops import tile

    k_hilo_np, bias_np = gray_kernel_int()
    kern = jnp.asarray(k_hilo_np).astype(jnp.bfloat16)
    bias = jnp.asarray(bias_np)
    flat = tile.blockify(plane).reshape(-1, 64)
    out = jax.lax.dot_general(
        flat.astype(jnp.bfloat16), kern, (((1,), (0,)), ((), ())),
        precision=_EXACT_DOT, preferred_element_type=jnp.float32,
    )
    acc = (
        out[:, :64].astype(jnp.int32) * (1 << _HI_SHIFT)
        + out[:, 64:].astype(jnp.int32)
        + bias
    )
    from jpeg_tpu import tables

    order = jnp.asarray(tables.ZIGZAG_ORDER)
    d = qy.reshape(64)[order].astype(jnp.int32) << _INT_SCALE_BITS
    q0 = (2 * jnp.abs(acc) + d) // (2 * d)
    return jnp.where(acc < 0, -q0, q0)


def _mcu_transform_conv_f32(rgb, qy, qc, mode: Subsampling):
    """The f32 HIGHEST conv form, kept for A/B. Deterministic per
    executable, but cross-executable bytes can differ by .5-boundary
    rounding flips under different fusions — superseded by
    _mcu_transform_int."""
    from jpeg_tpu.ops import quant

    kern_np, bias_np = mcu_kernel(mode)
    kern = jnp.asarray(kern_np)
    bias = jnp.asarray(bias_np)
    hv = mode.h_factor * mode.v_factor
    out = jax.lax.conv_general_dilated(
        rgb.astype(jnp.float32)[None], kern,
        window_strides=(mode.mcu_height, mode.mcu_width), padding="VALID",
        dimension_numbers=("NHWC", "HWIO", "NHWC"), precision=_PRECISION,
    )[0]
    coeff = out.reshape(-1, (hv + 2) * 64) + bias
    q = quant.round_half_away(coeff / zigzag_qdiv(qy, qc, hv))
    return q.astype(jnp.int32).reshape(-1, hv + 2, 64)


def mcu_transform(rgb, qy, qc, mode: Subsampling):
    """uint8 (H, W, 3), MCU-aligned -> (n_mcu, hv+2, 64) int32 quantized
    zig-zag blocks, MCU-interleaved in scan order (DC not yet DPCM'd).

    Backend routing (platform-local byte stability — every encode path on a
    given backend goes through the same branch): CPU uses the staged
    low-FLOP form; accelerators the exact fixed-point matmul, whose
    coefficients are additionally bit-identical across executables."""
    if jax.default_backend() == "cpu":
        return _mcu_transform_staged(rgb, qy, qc, mode)
    return _mcu_transform_int(rgb, qy, qc, mode)
