"""Generalized per-component sampling factors in the decoder (spec A.1.1).

The reference never got past 4:4:4 (its 4:2:2/4:2:0 are "not ready yet" stubs,
src/downsample.c:24-32) and has no decoder at all. Real-world baseline streams
use layouts beyond the common three — 4:4:0 (luma (1,2)), 4:1:1, and mixed
chroma factors — so these tests hand-craft interleaved streams with exotic
factors via our own JFIF writer + entropy encoder and check our decode against
PIL (libjpeg) as the independent oracle, plus backend bit-identity.
"""

import io

import numpy as np
import pytest
from PIL import Image

from jpeg_tpu.entropy import encode_np, huffman
from jpeg_tpu.io import jfif
from jpeg_tpu.models import layout
from jpeg_tpu.models.decoder import decode
from jpeg_tpu.ops import quant

from conftest import psnr


def _craft_stream(rng, comps_hv, h=48, w=64, restart=0):
    """Build a valid interleaved baseline JPEG with the given per-component
    (h, v) sampling factors and random sparse coefficients."""
    hmax = max(hh for hh, _ in comps_hv)
    vmax = max(vv for _, vv in comps_hv)
    mcu_rows = layout.ceil_div(h, 8 * vmax)
    mcu_cols = layout.ceil_div(w, 8 * hmax)
    n_mcu = mcu_rows * mcu_cols

    per_comp = []
    for ci, (hh, vv) in enumerate(comps_hv):
        n = n_mcu * hh * vv
        bl = np.zeros((n, 64), np.int64)
        # Smooth content: low-frequency AC only, gentle DC drift — so the
        # PIL comparison measures geometry/sampling correctness, not
        # upsample-filter differences amplified by broadband noise.
        lo = slice(1, 6) if ci == 0 else slice(1, 3)
        bl[:, lo] = rng.integers(-4, 5, (n, lo.stop - lo.start))
        hot = rng.random(n) < 0.2
        bl[hot, 0] = rng.integers(-2, 3, int(hot.sum()))
        per_comp.append(bl)

    rows, tbl = [], []
    for m in range(n_mcu):
        for ci, (hh, vv) in enumerate(comps_hv):
            bpm = hh * vv
            rows.append(per_comp[ci][m * bpm : (m + 1) * bpm])
            tbl += [0 if ci == 0 else 1] * bpm
    blocks = np.concatenate(rows, axis=0)
    tbl = np.array(tbl, dtype=np.int64)
    bpm_total = sum(hh * vv for hh, vv in comps_hv)

    huff = huffman.standard_tables()
    scan = encode_np.encode_scan(blocks, tbl, tbl, huff,
                                 restart_interval=restart,
                                 blocks_per_mcu=bpm_total)
    comps = [
        jfif.ComponentSpec(ci + 1, hh, vv, 0 if ci == 0 else 1,
                           0 if ci == 0 else 1, 0 if ci == 0 else 1)
        for ci, (hh, vv) in enumerate(comps_hv)
    ]
    qtabs = {0: quant.luma_table(75), 1: quant.chroma_table(75)}
    return jfif.write_jpeg(w, h, comps, qtabs, huff, scan,
                           restart_interval=restart)


LAYOUTS = [
    pytest.param([(1, 2), (1, 1), (1, 1)], id="440-luma-1x2"),
    pytest.param([(2, 1), (1, 1), (1, 1)], id="422"),
    pytest.param([(4, 1), (1, 1), (1, 1)], id="411"),
    pytest.param([(2, 2), (2, 1), (1, 1)], id="mixed-chroma"),
    pytest.param([(2, 2), (1, 2), (2, 1)], id="mixed-both"),
    pytest.param([(3, 1), (1, 1), (3, 1)], id="non-pow2-h3"),
]


@pytest.mark.parametrize("comps_hv", LAYOUTS)
def test_exotic_sampling_matches_pil(rng, comps_hv):
    jpg = _craft_stream(rng, comps_hv, h=41, w=59, restart=3)
    try:
        pil = np.asarray(Image.open(io.BytesIO(jpg)).convert("RGB"))
    except Exception:
        pytest.skip("PIL rejected this layout")
    ours = decode(jpg)
    assert ours.shape == pil.shape
    # Chroma upsampling filters differ (our triangular vs libjpeg's per-case
    # fancy/replication mix), so compare by PSNR like the other foreign tests.
    assert psnr(ours, pil) > 30.0, psnr(ours, pil)


@pytest.mark.parametrize("comps_hv", LAYOUTS[:4])
def test_exotic_sampling_backend_identity(rng, comps_hv):
    jpg = _craft_stream(rng, comps_hv, h=33, w=40, restart=2)
    np.testing.assert_array_equal(
        decode(jpg, entropy="device"), decode(jpg, entropy="numpy")
    )


@pytest.mark.parametrize("mode", ["411", "440"])
@pytest.mark.parametrize("optimize", [False, True])
def test_encode_411_440(photo, mode, optimize):
    """Encoder-side 4:1:1 / 4:4:0 (beyond the reference's 3-mode contract):
    PIL must decode our streams, and our decoder must agree with PIL."""
    from jpeg_tpu.models.encoder import encode

    jpg = encode(photo, quality=85, subsampling=mode, restart_interval=4,
                 optimize_tables=optimize)
    pil = np.asarray(Image.open(io.BytesIO(jpg)).convert("RGB"))
    ours = decode(jpg)
    assert ours.shape == pil.shape == photo.shape
    # 4x chroma upsampling filters differ more than 2x ones (our chained
    # triangular vs libjpeg's replication for h4): agreement is ~39 dB on
    # 4:1:1 and ~45+ dB on 4:4:0.
    assert psnr(ours, pil) > 36.0, psnr(ours, pil)
    assert psnr(ours, photo) > 28.0
    np.testing.assert_array_equal(ours, decode(jpg, entropy="numpy"))


def test_rgb_jpeg_pil_keep_rgb(rng):
    """RGB-color-space JPEG (libjpeg 'R','G','B' component ids + Adobe
    APP14 transform=0): decoded without the YCbCr matrix."""
    img = np.clip(
        rng.integers(0, 256, (3,)) // 2
        + np.mgrid[0:64, 0:80][0][..., None] * np.array([1, 2, 0]),
        0, 255,
    ).astype(np.uint8)
    buf = io.BytesIO()
    try:
        Image.fromarray(img).save(buf, "JPEG", quality=95, keep_rgb=True,
                                  subsampling=0)
    except (TypeError, ValueError, OSError):
        pytest.skip("PIL build lacks keep_rgb")
    jpg = buf.getvalue()
    info = jfif.parse_jpeg(jpg)
    assert tuple(c.comp_id for c in info.components) == (0x52, 0x47, 0x42)
    ours = decode(jpg)
    pil = np.asarray(Image.open(io.BytesIO(jpg)).convert("RGB"))
    assert psnr(ours, pil) > 45.0, psnr(ours, pil)
    # Content check: a YCbCr misinterpretation would destroy the gradient.
    assert psnr(ours, img) > 30.0, psnr(ours, img)


def test_noninteger_ratio_rejected(rng):
    jpg = _craft_stream(rng, [(3, 1), (2, 1), (1, 1)], h=24, w=24)
    with pytest.raises(jfif.JpegFormatError):
        decode(jpg)


def test_too_many_blocks_per_mcu_rejected(rng):
    jpg = _craft_stream(rng, [(4, 2), (2, 1), (1, 1)], h=16, w=32)
    with pytest.raises(jfif.JpegFormatError):
        decode(jpg)
