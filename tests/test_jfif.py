"""JFIF marker-level parser/writer robustness (crafted streams)."""

import io
import struct

import numpy as np
import pytest
from PIL import Image

from jpeg_tpu import decode, encode
from jpeg_tpu.io import jfif

from conftest import psnr


def _make_jpg(rng, h=32, w=32, **kw):
    img = rng.integers(0, 256, size=(h, w, 3)).astype(np.uint8)
    return img, encode(img, quality=80, **kw)


def test_parse_our_stream_fields(rng):
    img, jpg = _make_jpg(rng, subsampling="420", restart_interval=1)
    info = jfif.parse_jpeg(jpg)
    assert (info.width, info.height) == (32, 32)
    assert [c.comp_id for c in info.components] == [1, 2, 3]
    assert (info.components[0].h, info.components[0].v) == (2, 2)
    assert info.restart_interval == 1
    assert set(info.qtables) == {0, 1}
    assert set(info.htables) == {(0, 0), (0, 1), (1, 0), (1, 1)}


def test_combined_dht_segment(rng):
    """All four tables in ONE DHT segment (legal per B.2.4.2; libjpeg does
    this with optimize=True)."""
    img, jpg = _make_jpg(rng)
    info = jfif.parse_jpeg(jpg)
    # Rebuild the file with DHTs merged into a single segment.
    out = io.BytesIO()
    data = jpg
    pos = 2
    out.write(data[:2])
    dht_payloads = []
    segments = []
    while True:
        marker = data[pos + 1]
        seglen = struct.unpack_from(">H", data, pos + 2)[0]
        seg = data[pos : pos + 2 + seglen]
        if marker == jfif.DHT:
            dht_payloads.append(seg[4:])
        elif marker == jfif.SOS:
            merged = b"".join(dht_payloads)
            out.write(struct.pack(">BBH", 0xFF, jfif.DHT, len(merged) + 2) + merged)
            out.write(data[pos:])
            break
        else:
            out.write(seg)
        pos += 2 + seglen
    merged_jpg = out.getvalue()
    info2 = jfif.parse_jpeg(merged_jpg)
    assert set(info2.htables) == set(info.htables)
    np.testing.assert_array_equal(decode(merged_jpg), decode(jpg))


def test_16bit_dqt(rng):
    """Pq=1 (16-bit) quant table values must parse."""
    img, jpg = _make_jpg(rng)
    info = jfif.parse_jpeg(jpg)
    q = np.asarray(info.qtables[0]).reshape(64)
    # Rewrite the first DQT as 16-bit precision.
    pos = 2
    out = io.BytesIO()
    out.write(jpg[:2])
    done = False
    data = jpg
    while True:
        marker = data[pos + 1]
        seglen = struct.unpack_from(">H", data, pos + 2)[0]
        seg = data[pos : pos + 2 + seglen]
        if marker == jfif.DQT and not done:
            tq = seg[4] & 15
            zz = np.frombuffer(seg[5:69], np.uint8).astype(">u2")
            payload = bytes([(1 << 4) | tq]) + zz.tobytes()
            out.write(struct.pack(">BBH", 0xFF, jfif.DQT, len(payload) + 2) + payload)
            done = True
        else:
            out.write(seg)
        pos += 2 + seglen
        if marker == jfif.SOS:
            break
    out.write(data[pos:])
    info2 = jfif.parse_jpeg(out.getvalue())
    np.testing.assert_array_equal(info2.qtables[0], info.qtables[0])
    np.testing.assert_array_equal(decode(out.getvalue()), decode(jpg))


def test_trailing_garbage_after_eoi(rng):
    img, jpg = _make_jpg(rng)
    np.testing.assert_array_equal(decode(jpg + b"\x00garbage"), decode(jpg))


def test_app_and_com_segments_skipped(rng):
    img, jpg = _make_jpg(rng)
    # Inject APP13 + COM right after SOI.
    extra = (
        struct.pack(">BBH", 0xFF, 0xED, 10) + b"Adobe!!!"
        + struct.pack(">BBH", 0xFF, 0xFE, 7) + b"hello"
    )
    patched = jpg[:2] + extra + jpg[2:]
    np.testing.assert_array_equal(decode(patched), decode(jpg))


def test_missing_sos():
    data = b"\xff\xd8" + struct.pack(">BBH", 0xFF, 0xFE, 4) + b"hi" + b"\xff\xd9"
    with pytest.raises(jfif.JpegFormatError):
        jfif.parse_jpeg(data)


def test_comment_roundtrip(rng):
    img = rng.integers(0, 256, size=(16, 16, 3)).astype(np.uint8)
    jpg = encode(img, comment="jpeg engine test comment")
    assert b"jpeg engine test comment" in jpg
    decode(jpg)  # still decodable


def test_write_parse_identity(rng):
    """Everything we write must parse back to the same structural fields."""
    for mode, r in [("444", 0), ("422", 3), ("420", 5)]:
        img, jpg = _make_jpg(rng, h=48, w=64, subsampling=mode,
                             restart_interval=r)
        info = jfif.parse_jpeg(jpg)
        assert info.restart_interval == r
        pil = np.asarray(Image.open(io.BytesIO(jpg)).convert("RGB"))
        assert pil.shape == (48, 64, 3)


def test_noninterleaved_multiscan_decode(rng):
    """3 single-component scans (legal baseline, A.2.2) must decode and match
    the equivalent interleaved stream."""
    import jax.numpy as jnp
    from jpeg_tpu.entropy import encode_np, huffman
    from jpeg_tpu.models import encoder as E
    from jpeg_tpu.config import Subsampling
    from jpeg_tpu.ops import quant

    h, w = 32, 48
    img = rng.integers(0, 256, size=(h, w, 3)).astype(np.uint8)
    interleaved = encode(img, quality=75, subsampling="444")

    mode = Subsampling.YUV444
    qy, qc = quant.luma_table(75), quant.chroma_table(75)
    y, cb, cr = (np.asarray(a) for a in E._jit_color(mode)(
        jnp.asarray(img), jnp.asarray(qy), jnp.asarray(qc)))
    ht = huffman.standard_tables()

    def one_scan(blocks, tbl_id):
        b = blocks.astype(np.int64).copy()
        b[1:, 0] = blocks[1:, 0] - blocks[:-1, 0]
        tbl = np.full(len(b), tbl_id, dtype=np.int64)
        return encode_np.encode_scan(b, tbl, tbl, ht)

    out = io.BytesIO()
    out.write(b"\xff\xd8")
    for qid, q in [(0, qy), (1, qc)]:
        zz = np.asarray(q, np.int32).reshape(64)[
            __import__("jpeg_tpu.tables", fromlist=["x"]).ZIGZAG_ORDER]
        out.write(struct.pack(">BBH", 0xFF, jfif.DQT, 67) + bytes([qid])
                  + bytes(int(x) for x in zz))
    sof = struct.pack(">BHHB", 8, h, w, 3)
    for cid, qid in [(1, 0), (2, 1), (3, 1)]:
        sof += struct.pack(">BBB", cid, 0x11, qid)
    out.write(struct.pack(">BBH", 0xFF, jfif.SOF0, len(sof) + 2) + sof)
    for (is_ac, tid), t in sorted(ht.items()):
        p = bytes([(is_ac << 4) | tid]) + bytes(int(x) for x in t.bits) \
            + bytes(int(x) for x in t.vals)
        out.write(struct.pack(">BBH", 0xFF, jfif.DHT, len(p) + 2) + p)
    for cid, tid, blocks in [(1, 0, y), (2, 1, cb), (3, 1, cr)]:
        sos = bytes([1]) + struct.pack(">BB", cid, (tid << 4) | tid) + bytes([0, 63, 0])
        out.write(struct.pack(">BBH", 0xFF, jfif.SOS, len(sos) + 2) + sos)
        out.write(one_scan(blocks, tid))
    out.write(b"\xff\xd9")
    multiscan = out.getvalue()

    ours = decode(multiscan)
    ref = decode(interleaved)
    np.testing.assert_array_equal(ours, ref)
    pil = np.asarray(Image.open(io.BytesIO(multiscan)).convert("RGB"))
    np.testing.assert_array_equal(
        pil, np.asarray(Image.open(io.BytesIO(interleaved)).convert("RGB")))


def test_tables_redefined_between_scans(rng):
    """DHT redefinition between non-interleaved scans: each scan must use its
    own snapshot (B.2.4.2 allows table redefinition mid-stream)."""
    import jax.numpy as jnp
    from jpeg_tpu.entropy import encode_np, huffman
    from jpeg_tpu.models import encoder as E
    from jpeg_tpu.config import Subsampling
    from jpeg_tpu.ops import quant
    from jpeg_tpu import tables as T

    h, w = 16, 16
    img = rng.integers(0, 256, size=(h, w, 3)).astype(np.uint8)
    mode = Subsampling.YUV444
    qy, qc = quant.luma_table(75), quant.chroma_table(75)
    y, cb, cr = (np.asarray(a) for a in E._jit_color(mode)(
        jnp.asarray(img), jnp.asarray(qy), jnp.asarray(qc)))

    std = huffman.standard_tables()
    # "Redefined" tables for the chroma scans: luma-style tables under id 0.
    alt = {(0, 0): std[(0, 1)], (1, 0): std[(1, 1)]}

    def one_scan(blocks, ht):
        b = blocks.astype(np.int64).copy()
        b[1:, 0] = blocks[1:, 0] - blocks[:-1, 0]
        tbl = np.zeros(len(b), dtype=np.int64)
        return encode_np.encode_scan(b, tbl, tbl, ht)

    def dht_seg(ht):
        out = b""
        for (is_ac, tid), t in sorted(ht.items()):
            p = bytes([(is_ac << 4) | tid]) + bytes(int(x) for x in t.bits) \
                + bytes(int(x) for x in t.vals)
            out += struct.pack(">BBH", 0xFF, jfif.DHT, len(p) + 2) + p
        return out

    buf = io.BytesIO()
    buf.write(b"\xff\xd8")
    for qid, q in [(0, qy), (1, qc)]:
        zz = np.asarray(q, np.int32).reshape(64)[T.ZIGZAG_ORDER]
        buf.write(struct.pack(">BBH", 0xFF, jfif.DQT, 67) + bytes([qid])
                  + bytes(int(x) for x in zz))
    sof = struct.pack(">BHHB", 8, h, w, 3)
    for cid, qid in [(1, 0), (2, 1), (3, 1)]:
        sof += struct.pack(">BBB", cid, 0x11, qid)
    buf.write(struct.pack(">BBH", 0xFF, jfif.SOF0, len(sof) + 2) + sof)

    # Scan 1 (luma) with the standard id-0 tables...
    buf.write(dht_seg({(0, 0): std[(0, 0)], (1, 0): std[(1, 0)]}))
    sos = bytes([1]) + struct.pack(">BB", 1, 0x00) + bytes([0, 63, 0])
    buf.write(struct.pack(">BBH", 0xFF, jfif.SOS, len(sos) + 2) + sos)
    buf.write(one_scan(y, {(0, 0): std[(0, 0)], (1, 0): std[(1, 0)]}))
    # ...then REDEFINE id 0 before the chroma scans.
    buf.write(dht_seg(alt))
    for cid, blocks in [(2, cb), (3, cr)]:
        sos = bytes([1]) + struct.pack(">BB", cid, 0x00) + bytes([0, 63, 0])
        buf.write(struct.pack(">BBH", 0xFF, jfif.SOS, len(sos) + 2) + sos)
        buf.write(one_scan(blocks, alt))
    buf.write(b"\xff\xd9")
    data = buf.getvalue()

    ours = decode(data)
    pil = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
    np.testing.assert_array_equal(ours.shape, pil.shape)
    assert psnr(ours, pil) > 45.0


def test_mixed_dc_ac_table_ids_uses_numpy_fallback(rng):
    """A scan with Td != Ta is legal; the native decoder declines it and the
    NumPy path must handle it."""
    import jax.numpy as jnp
    from jpeg_tpu.entropy import encode_np, huffman
    from jpeg_tpu.models import encoder as E
    from jpeg_tpu.ops import quant
    from jpeg_tpu import tables as T

    h, w = 16, 24
    img = rng.integers(0, 256, size=(h, w)).astype(np.uint8)
    qy = quant.luma_table(75)
    zz = np.asarray(E._jit_gray()(jnp.asarray(img), jnp.asarray(qy))).astype(np.int64)
    zz[1:, 0] = zz[1:, 0] - np.asarray(
        E._jit_gray()(jnp.asarray(img), jnp.asarray(qy)))[:-1, 0]

    std = huffman.standard_tables()
    dc_tbl = np.zeros(len(zz), dtype=np.int64)   # DC table id 0
    ac_tbl = np.ones(len(zz), dtype=np.int64)    # AC table id 1 (chroma-style)
    scan = encode_np.encode_scan(zz, dc_tbl, ac_tbl, std)

    buf = io.BytesIO()
    buf.write(b"\xff\xd8")
    zzq = np.asarray(qy, np.int32).reshape(64)[T.ZIGZAG_ORDER]
    buf.write(struct.pack(">BBH", 0xFF, jfif.DQT, 67) + bytes([0])
              + bytes(int(x) for x in zzq))
    sof = struct.pack(">BHHB", 8, h, w, 1) + struct.pack(">BBB", 1, 0x11, 0)
    buf.write(struct.pack(">BBH", 0xFF, jfif.SOF0, len(sof) + 2) + sof)
    for (is_ac, tid) in [(0, 0), (1, 1)]:
        t = std[(is_ac, tid)]
        p = bytes([(is_ac << 4) | tid]) + bytes(int(x) for x in t.bits) \
            + bytes(int(x) for x in t.vals)
        buf.write(struct.pack(">BBH", 0xFF, jfif.DHT, len(p) + 2) + p)
    sos = bytes([1]) + struct.pack(">BB", 1, 0x01) + bytes([0, 63, 0])  # Td=0 Ta=1
    buf.write(struct.pack(">BBH", 0xFF, jfif.SOS, len(sos) + 2) + sos)
    buf.write(scan)
    buf.write(b"\xff\xd9")
    data = buf.getvalue()

    ours = decode(data)
    pil = np.asarray(Image.open(io.BytesIO(data)).convert("L"))
    assert psnr(ours, pil) > 45.0


@pytest.mark.parametrize("restart", [0, 5])
@pytest.mark.parametrize("optimize", [False, True])
def test_encode_noninterleaved(rng, restart, optimize):
    """Our non-interleaved writer: PIL and our decoder both read it, pixels
    match the interleaved 4:4:4 encoding exactly."""
    from jpeg_tpu import encode_noninterleaved

    img = rng.integers(0, 256, size=(24, 40, 3)).astype(np.uint8)
    jpg = encode_noninterleaved(img, quality=80, restart_interval=restart,
                                optimize_tables=optimize)
    ref = encode(img, quality=80, subsampling="444", restart_interval=restart)
    pil_a = np.asarray(Image.open(io.BytesIO(jpg)).convert("RGB"))
    pil_b = np.asarray(Image.open(io.BytesIO(ref)).convert("RGB"))
    np.testing.assert_array_equal(pil_a, pil_b)
    np.testing.assert_array_equal(decode(jpg), decode(ref))
    info = jfif.parse_jpeg(jpg)
    assert len(info.scans) == 3


def test_huge_frame_header_rejected():
    """A tiny file declaring a 12.9-GPix frame must not attempt allocation."""
    data = io.BytesIO()
    data.write(b"\xff\xd8")
    sof = struct.pack(">BHHB", 8, 65535, 65535, 1) + struct.pack(">BBB", 1, 0x11, 0)
    data.write(struct.pack(">BBH", 0xFF, jfif.SOF0, len(sof) + 2) + sof)
    zz = bytes(64)
    data.write(struct.pack(">BBH", 0xFF, jfif.DQT, 67) + bytes([0]) + zz)
    sos = bytes([1]) + struct.pack(">BB", 1, 0x00) + bytes([0, 63, 0])
    data.write(struct.pack(">BBH", 0xFF, jfif.SOS, len(sos) + 2) + sos)
    data.write(b"\x00\xff\xd9")
    with pytest.raises(jfif.JpegFormatError):
        decode(data.getvalue())
