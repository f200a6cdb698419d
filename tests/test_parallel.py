"""Multi-chip sharding tests on the 8-device virtual CPU mesh.

Checks the distributed pipeline is bit-identical to the single-device path:
same quantized coefficients, same DPCM diffs across stripe boundaries
(ppermute exchange), same global symbol histograms (psum), and decodable
output streams (SURVEY.md §4 item (d), BASELINE configs 4-5).
"""

import io

import numpy as np
import pytest
from PIL import Image

import jax

from jpeg_tpu import decode, encode
from jpeg_tpu.config import Subsampling
from jpeg_tpu.entropy import encode_np
from jpeg_tpu.models.encoder import interleave_mcus
from jpeg_tpu.ops import quant
from jpeg_tpu.parallel import batch as pbatch
from jpeg_tpu.parallel import shard
from jpeg_tpu.parallel.mesh import make_mesh

from conftest import psnr


def _test_imgs(rng, b=4, h=64, w=48):
    """Gradient base + mild noise: compressible but with non-trivial entropy."""
    yy, xx = np.mgrid[0:h, 0:w]
    grad = np.stack([xx * 255 / w, yy * 255 / h, (xx + yy) * 128 / (h + w)], -1)
    noise = rng.integers(-12, 13, size=(b, h, w, 3))
    return np.clip(grad[None] + noise, 0, 255).astype(np.uint8)


def test_mesh_shapes():
    m = make_mesh(8)
    assert m.shape["batch"] * m.shape["mcu"] == 8
    m2 = make_mesh(8, batch_axis=4)
    assert m2.shape == {"batch": 4, "mcu": 2}
    with pytest.raises(ValueError):
        make_mesh(8, batch_axis=3)


@pytest.mark.parametrize("mode", [Subsampling.YUV444, Subsampling.YUV420])
@pytest.mark.parametrize("stripe_restart", [False, True])
def test_sharded_blocks_match_single_device(rng, mode, stripe_restart):
    imgs = _test_imgs(rng, b=2, h=mode.mcu_height * 4, w=mode.mcu_width * 3)
    mesh = make_mesh(8, batch_axis=2)  # 2-way batch, 4-way stripes
    qy, qc = quant.luma_table(75), quant.chroma_table(75)
    y, cb, cr, hists = shard.sharded_encode_blocks(
        imgs, qy, qc, mesh, mode, stripe_restart=stripe_restart
    )
    y, cb, cr = np.asarray(y), np.asarray(cb), np.asarray(cr)

    # Single-device reference: encode() path internals, per image.
    mesh1 = make_mesh(1, batch_axis=1)
    y1, cb1, cr1, hists1 = shard.sharded_encode_blocks(
        imgs, qy, qc, mesh1, mode, stripe_restart=False
    )
    y1, cb1, cr1 = np.asarray(y1), np.asarray(cb1), np.asarray(cr1)

    if not stripe_restart:
        np.testing.assert_array_equal(y, y1)
        np.testing.assert_array_equal(cb, cb1)
        np.testing.assert_array_equal(cr, cr1)
        np.testing.assert_array_equal(np.asarray(hists), np.asarray(hists1))
    else:
        # AC coefficients identical; only stripe-boundary DC diffs differ.
        np.testing.assert_array_equal(y[:, :, 1:], y1[:, :, 1:])
        np.testing.assert_array_equal(cb[:, :, 1:], cb1[:, :, 1:])


def test_sharded_hists_match_numpy(rng):
    """psum'd device histograms == the NumPy record-stream frequency counts."""
    mode = Subsampling.YUV444
    imgs = _test_imgs(rng, b=2, h=32, w=24)
    mesh = make_mesh(4, batch_axis=2)
    qy, qc = quant.luma_table(60), quant.chroma_table(60)
    y, cb, cr, hists = shard.sharded_encode_blocks(imgs, qy, qc, mesh, mode)
    y, cb, cr = np.asarray(y), np.asarray(cb), np.asarray(cr)
    hists = np.asarray(hists)

    dc_l = np.zeros(256, np.int64)
    ac_l = np.zeros(256, np.int64)
    dc_c = np.zeros(256, np.int64)
    ac_c = np.zeros(256, np.int64)
    for i in range(imgs.shape[0]):
        blocks, tbl = interleave_mcus(y[i], cb[i], cr[i], 1)
        rec = encode_np.build_records(blocks, tbl, tbl)
        f = encode_np.count_frequencies(rec)
        dc_l += f[(0, 0)]
        ac_l += f[(1, 0)]
        dc_c += f[(0, 1)]
        ac_c += f[(1, 1)]
    np.testing.assert_array_equal(hists[0], dc_l)
    np.testing.assert_array_equal(hists[1], ac_l)
    np.testing.assert_array_equal(hists[2], dc_c)
    np.testing.assert_array_equal(hists[3], ac_c)


@pytest.mark.parametrize("optimize", [False, True])
def test_encode_batch_streams_decodable(rng, optimize):
    imgs = _test_imgs(rng, b=2, h=64, w=48)
    mesh = make_mesh(8, batch_axis=2)
    outs = pbatch.encode_batch(
        imgs, quality=80, subsampling="420", mesh=mesh,
        stripe_restart=True, optimize_tables=optimize,
    )
    assert len(outs) == 2
    for i, jpg in enumerate(outs):
        pil = np.asarray(Image.open(io.BytesIO(jpg)).convert("RGB"))
        assert pil.shape == imgs[i].shape
        assert psnr(pil, imgs[i]) > 25.0
        ours = decode(jpg)
        assert psnr(ours, pil) > 28.0


def test_encode_batch_matches_unsharded_encoder(rng):
    """Sharded batch pipeline must produce byte-identical streams to the
    single-image encoder when stripes are disabled."""
    imgs = _test_imgs(rng, b=2, h=64, w=48)
    mesh = make_mesh(2, batch_axis=2)  # batch-parallel only
    outs = pbatch.encode_batch(
        imgs, quality=75, subsampling="420", mesh=mesh, stripe_restart=False
    )
    for i, jpg in enumerate(outs):
        solo = encode(imgs[i], quality=75, subsampling="420")
        assert jpg == solo


def test_odd_batch_padding(rng):
    imgs = _test_imgs(rng, b=2, h=50, w=30)  # not MCU-aligned
    mesh = make_mesh(4, batch_axis=2)
    outs = pbatch.encode_batch(imgs, quality=85, subsampling="420", mesh=mesh)
    for i, jpg in enumerate(outs):
        pil = np.asarray(Image.open(io.BytesIO(jpg)).convert("RGB"))
        assert pil.shape == imgs[i].shape


def test_mosaic_single_jfif(rng):
    """Config 5: tile grid -> one spec-compliant JFIF, stripe-sharded."""
    from jpeg_tpu.parallel import mosaic

    tiles = _test_imgs(rng, b=16, h=64, w=64).reshape(4, 4, 64, 64, 3)
    big = mosaic.assemble_tiles(tiles)
    assert big.shape == (256, 256, 3)
    mesh = make_mesh(8, batch_axis=1)  # 8-way stripe sharding
    jpg = mosaic.encode_mosaic(big, quality=80, mesh=mesh)
    pil = np.asarray(Image.open(io.BytesIO(jpg)).convert("RGB"))
    assert pil.shape == big.shape
    assert psnr(pil, big) > 25.0
    ours = decode(jpg)
    assert psnr(ours, pil) > 28.0
    # restart markers present (stripe seams)
    from jpeg_tpu.io import jfif
    info = jfif.parse_jpeg(jpg)
    assert info.restart_interval > 0


def test_encode_stream_matches_encode(rng):
    """Pipelined streaming encode must produce the same bytes as encode()."""
    from jpeg_tpu.parallel.pipeline import encode_stream

    imgs = [_test_imgs(rng, b=1, h=48, w=32)[0] for _ in range(5)]
    imgs.append(_test_imgs(rng, b=1, h=64, w=64)[0])  # geometry change mid-stream
    outs = list(encode_stream(imgs, quality=80, subsampling="420",
                              device_pack=True))
    assert len(outs) == len(imgs)
    for img, jpg in zip(imgs, outs):
        assert jpg == encode(img, quality=80, subsampling="420")


def test_encode_stream_optimized_tables(rng):
    """optimize_tables=True streams per-image
    optimal-table encodes byte-identical to encode(optimize_tables=True) —
    the histogram program rides the pipeline, the upload is shared."""
    from jpeg_tpu.parallel.pipeline import encode_stream

    imgs = [_test_imgs(rng, b=1, h=48, w=64)[0] for _ in range(3)]
    outs = list(encode_stream(imgs, quality=80, subsampling="420",
                              device_pack=True, optimize_tables=True))
    for img, jpg in zip(imgs, outs):
        assert jpg == encode(img, quality=80, subsampling="420",
                             optimize_tables=True)
    # Host path carries the flag too.
    outs = list(encode_stream(imgs[:1], quality=80, subsampling="420",
                              device_pack=False, optimize_tables=True))
    assert outs[0] == encode(imgs[0], quality=80, subsampling="420",
                             optimize_tables=True)


@pytest.mark.parametrize("mode", [Subsampling.YUV444, Subsampling.YUV420])
def test_sharded_decode_matches_single_device(rng, mode):
    """Distributed decode finishing (with halo exchange for the triangular
    upsample) must be bit-identical to the single-device decoder."""
    from jpeg_tpu.models import decoder as D
    from jpeg_tpu.ops import quant
    import jax.numpy as jnp

    mesh = make_mesh(8, batch_axis=2)
    sp = mesh.shape["mcu"]
    mcu_rows, mcu_cols = sp * 2, 3
    hf, vf = mode.h_factor, mode.v_factor
    b = 2
    n_y = mcu_rows * vf * mcu_cols * hf
    n_c = mcu_rows * mcu_cols
    y = rng.integers(-40, 40, size=(b, n_y, 64)).astype(np.int32)
    cb = rng.integers(-20, 20, size=(b, n_c, 64)).astype(np.int32)
    cr = rng.integers(-20, 20, size=(b, n_c, 64)).astype(np.int32)
    qy, qc = quant.luma_table(75), quant.chroma_table(75)

    got = np.asarray(shard.sharded_decode_pixels(
        y, cb, cr, qy, qc, mcu_cols, mesh, mode))

    fin = D._jit_finish_color(
        ((mcu_rows * vf, mcu_cols * hf), (mcu_rows, mcu_cols),
         (mcu_rows, mcu_cols)),
        ((1, 1), (hf, vf), (hf, vf)), True)
    for i in range(b):
        expect = np.asarray(fin(
            jnp.asarray(y[i]), jnp.asarray(cb[i]), jnp.asarray(cr[i]),
            jnp.asarray(qy), jnp.asarray(qc), jnp.asarray(qc)))
        np.testing.assert_array_equal(got[i], expect)


def test_device_packed_batch_matches_host_path(rng):
    """Per-stripe device entropy packing must produce byte-identical files to
    the host-packed stripe path."""
    imgs = _test_imgs(rng, b=2, h=64, w=48)
    mesh = make_mesh(8, batch_axis=2)
    a = pbatch.encode_batch(imgs, quality=80, subsampling="420", mesh=mesh,
                            stripe_restart=True, device_pack=True)
    b = pbatch.encode_batch(imgs, quality=80, subsampling="420", mesh=mesh,
                            stripe_restart=True, device_pack=False)
    assert a == b
    for jpg in a:
        assert decode(jpg).shape == imgs[0].shape


def test_device_packed_batch_optimized_tables_matches_host_path(rng):
    """optimize_tables must stay on the device-pack fast path (two device
    passes: psum'd histograms -> K.2 tables -> per-stripe packing) and still
    be byte-identical to the host-packed path."""
    imgs = _test_imgs(rng, b=2, h=64, w=48)
    mesh = make_mesh(8, batch_axis=2)
    a = pbatch.encode_batch(imgs, quality=80, subsampling="420", mesh=mesh,
                            stripe_restart=True, device_pack=True,
                            optimize_tables=True)
    b = pbatch.encode_batch(imgs, quality=80, subsampling="420", mesh=mesh,
                            stripe_restart=True, device_pack=False,
                            optimize_tables=True)
    assert a == b
    # Optimized tables must actually differ from the standard-table output
    # (i.e. the flag was not silently dropped).
    c = pbatch.encode_batch(imgs, quality=80, subsampling="420", mesh=mesh,
                            stripe_restart=True, device_pack=True)
    assert a != c
    for jpg in a:
        assert decode(jpg).shape == imgs[0].shape


def test_multihost_mesh_single_process():
    """Without a coordinator it degrades to the local mesh constructor."""
    from jpeg_tpu.parallel.mesh import make_multihost_mesh

    m = make_multihost_mesh(batch_axis=1)
    assert m.shape["batch"] == 1
    assert m.shape["batch"] * m.shape["mcu"] == len(jax.devices())


@pytest.mark.parametrize("mode,w", [
    ("444", 48), ("420", 48),
    # 4:1:1 (x4 horizontal chroma upsample, width-local
    # doubling chain) and 4:4:0 (vertical halo) in the sharded finisher too.
    ("411", 64), ("440", 48),
])
def test_decode_batch_matches_per_image_decode(rng, mode, w):
    """Batched sharded decode (config 4, decode direction) is bit-identical
    to per-image decode() across entropy backends."""
    imgs = _test_imgs(rng, b=4, h=64, w=w)
    mesh = make_mesh(8, batch_axis=2)
    jpgs = pbatch.encode_batch(imgs, quality=80, subsampling=mode, mesh=mesh)
    out = pbatch.decode_batch(jpgs, mesh=mesh)
    ref = np.stack([decode(j) for j in jpgs])
    np.testing.assert_array_equal(out, ref)
    np.testing.assert_array_equal(
        pbatch.decode_batch(jpgs, mesh=mesh, entropy="device"), ref
    )


def test_decode_batch_rejects_mixed_streams(rng):
    imgs = _test_imgs(rng, b=2, h=64, w=48)
    mesh = make_mesh(8, batch_axis=2)
    a = pbatch.encode_batch(imgs, quality=80, subsampling="420", mesh=mesh)
    b = pbatch.encode_batch(imgs, quality=50, subsampling="420", mesh=mesh)
    with pytest.raises(ValueError):
        pbatch.decode_batch([a[0], b[1]], mesh=mesh)


def test_decode_stream_matches_per_image(photo):
    """decode_stream yields per-image-identical pixels in input order, with
    heterogeneous geometries/settings in one stream."""
    from jpeg_tpu import decode, encode
    from jpeg_tpu.parallel.pipeline import decode_stream

    datas = [
        encode(photo, quality=80, subsampling="420"),
        encode(photo[:128, :160], quality=60, subsampling="444",
               restart_interval=3),
        encode(255 - photo, quality=90, subsampling="422",
               optimize_tables=True),
        encode(photo[..., 0], quality=75),  # grayscale mid-stream
    ]
    outs = list(decode_stream(datas, depth=2))
    assert len(outs) == len(datas)
    for d, got in zip(datas, outs):
        np.testing.assert_array_equal(got, decode(d))
    s2 = list(decode_stream(datas[:2], scale_denom=2))
    for d, got in zip(datas[:2], s2):
        np.testing.assert_array_equal(got, decode(d, scale_denom=2))


def test_encode_stream_q95_uses_retry_ladder(photo, monkeypatch):
    """The streaming finisher resumes the shared overflow retry ladder:
    q95 frames (which overflow the default tree budget) come out via the
    scale-2 device program, NOT the host fallback (host bytes are identical
    by design, so the test spies on _encode_color to prove the device path
    actually ran — r4 review finding)."""
    from jpeg_tpu import encode
    from jpeg_tpu.models import encoder as E
    from jpeg_tpu.parallel.pipeline import encode_stream

    want = [encode(im, quality=95, subsampling="420")
            for im in (photo, 255 - photo)]
    calls = []
    orig = E._encode_color
    monkeypatch.setattr(E, "_encode_color",
                        lambda *a, **k: calls.append(1) or orig(*a, **k))
    outs = list(encode_stream([photo, 255 - photo], quality=95,
                              subsampling="420", device_pack=True))
    assert outs == want
    assert not calls, "finisher fell back to host instead of the ladder"


def test_decode_stream_propagates_errors(photo):
    """A corrupt stream mid-batch raises at its yield position (futures
    resolve in input order), after earlier results were already yielded."""
    from jpeg_tpu import encode
    from jpeg_tpu.io import jfif
    from jpeg_tpu.parallel.pipeline import decode_stream

    good = encode(photo, quality=75, subsampling="420")
    it = decode_stream([good, b"not a jpeg", good], depth=1)
    first = next(it)
    assert first.shape == photo.shape
    with pytest.raises(jfif.JpegFormatError):
        list(it)
