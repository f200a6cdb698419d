"""BMP reader/writer vs the PIL oracle and the reference's sample assets."""

import io

import numpy as np
import pytest
from PIL import Image

from jpeg_tpu.io import bmp


@pytest.mark.parametrize("name", ["cam", "tiger"])
def test_reference_assets_match_pil(name, reference_src):
    """The two BMPs shipped in the reference C project's tree (SURVEY.md
    component 15): cam.bmp has a BITMAPV5 header, tiger.bmp a plain
    BITMAPINFOHEADER. Skipped where that tree is not mounted."""
    path = str(reference_src / "images" / f"{name}.bmp")
    ref = np.asarray(Image.open(path).convert("RGB"))
    np.testing.assert_array_equal(bmp.read_bmp(path), ref)


def test_roundtrip_odd_width(rng):
    """Row padding: odd widths exercise the 4-byte row alignment the reference
    mishandles (README.md:18-19)."""
    for w in (1, 2, 3, 5, 127):
        rgb = rng.integers(0, 256, size=(7, w, 3)).astype(np.uint8)
        out = bmp.decode_bmp(bmp.encode_bmp(rgb))
        np.testing.assert_array_equal(out, rgb)


def test_written_bmp_readable_by_pil(rng):
    rgb = rng.integers(0, 256, size=(13, 21, 3)).astype(np.uint8)
    data = bmp.encode_bmp(rgb)
    pil = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
    np.testing.assert_array_equal(pil, rgb)


def test_top_down_bmp(rng):
    rgb = rng.integers(0, 256, size=(4, 4, 3)).astype(np.uint8)
    data = bytearray(bmp.encode_bmp(rgb[::-1]))  # stored rows become top-down order
    # Flip the height sign to declare top-down.
    import struct

    struct.pack_into("<i", data, 22, -4)
    out = bmp.decode_bmp(bytes(data))
    np.testing.assert_array_equal(out, rgb[::-1][::-1])  # == rgb bottom-up flip twice


def test_errors():
    with pytest.raises(bmp.BmpError):
        bmp.decode_bmp(b"NOTABMP" * 20)
    with pytest.raises(bmp.BmpError):
        bmp.decode_bmp(b"BM" + b"\x00" * 100)  # zero dims / bad header


def _make_bitfields_bmp(rgb, masks, tmp_path=None):
    """32-bit BI_BITFIELDS file: 40-byte info header + 12 mask bytes."""
    import struct

    h, w, _ = rgb.shape
    stride = w * 4
    bgra = np.zeros((h, w, 4), dtype=np.uint8)
    bgra[..., :3] = rgb[::-1, :, ::-1]
    pix = bgra.tobytes()
    off = 14 + 40 + 12
    head = struct.pack("<2sIHHI", b"BM", off + len(pix), 0, 0, off)
    head += struct.pack("<IiiHHIIiiII", 40, w, h, 1, 32, 3, stride * h,
                        2835, 2835, 0, 0)
    head += struct.pack("<III", *masks)
    return head + pix


def test_bitfields_default_masks_accepted(rng):
    rgb = rng.integers(0, 256, size=(5, 7, 3)).astype(np.uint8)
    data = _make_bitfields_bmp(rgb, (0x00FF0000, 0x0000FF00, 0x000000FF))
    np.testing.assert_array_equal(bmp.decode_bmp(data), rgb)


def test_bitfields_nondefault_masks_rejected(rng, tmp_path):
    """Non-BGRA masks must be rejected, not silently channel-swapped
    — in both decode_bmp and the streaming BmpRowReader."""
    rgb = rng.integers(0, 256, size=(5, 7, 3)).astype(np.uint8)
    data = _make_bitfields_bmp(rgb, (0x000000FF, 0x0000FF00, 0x00FF0000))
    with pytest.raises(bmp.BmpError, match="masks"):
        bmp.decode_bmp(data)
    p = tmp_path / "bgr.bmp"
    p.write_bytes(data)
    with pytest.raises(bmp.BmpError, match="masks"):
        bmp.BmpRowReader(str(p))


def test_row_reader_matches_decode_bmp(rng, tmp_path):
    """BmpRowReader row ranges must equal slices of the full decode for
    bottom-up files, odd widths (padded rows) and arbitrary ranges."""
    rgb = rng.integers(0, 256, size=(23, 13, 3)).astype(np.uint8)
    path = tmp_path / "a.bmp"
    bmp.write_bmp(str(path), rgb)
    full = bmp.read_bmp(str(path))
    with bmp.BmpRowReader(str(path)) as r:
        assert (r.height, r.width) == (23, 13)
        for a, b in [(0, 23), (0, 1), (22, 23), (5, 17)]:
            np.testing.assert_array_equal(r.rows(a, b), full[a:b])
        with pytest.raises(ValueError):
            r.rows(5, 30)


def test_row_reader_top_down(rng, tmp_path):
    import struct

    rgb = rng.integers(0, 256, size=(6, 4, 3)).astype(np.uint8)
    data = bytearray(bmp.encode_bmp(rgb[::-1]))
    struct.pack_into("<i", data, 22, -6)
    path = tmp_path / "td.bmp"
    path.write_bytes(bytes(data))
    full = bmp.read_bmp(str(path))
    with bmp.BmpRowReader(str(path)) as r:
        np.testing.assert_array_equal(r.rows(1, 4), full[1:4])


def test_row_reader_streams_mosaic(rng, tmp_path):
    """End-to-end: BMP on disk -> streamed single-JFIF, identical bytes to
    the in-memory whole-image mosaic path."""
    from jpeg_tpu import encode
    from jpeg_tpu.parallel.mosaic import encode_mosaic_stream

    rgb = rng.integers(0, 256, size=(70, 40, 3)).astype(np.uint8)
    path = tmp_path / "m.bmp"
    bmp.write_bmp(str(path), rgb)
    with bmp.BmpRowReader(str(path)) as r:
        got = encode_mosaic_stream(r.rows, r.height, r.width, quality=80,
                                   stripe_rows=32)
    mcu_cols = -(-40 // 16)
    ref = encode(rgb, quality=80, subsampling="420",
                 restart_interval=mcu_cols)
    assert got == ref
