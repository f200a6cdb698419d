"""Native (C++) entropy runtime: byte-for-byte differential vs the NumPy codec."""

import io

import numpy as np
import pytest
from PIL import Image

from jpeg_tpu import decode, encode
from jpeg_tpu.entropy import decode_np, encode_np, huffman, native

pytestmark = pytest.mark.skipif(
    not native.available(), reason="native runtime unavailable (g++ missing?)"
)


def _random_blocks(rng, n, density=0.2, amp=200):
    blocks = np.zeros((n, 64), dtype=np.int64)
    mask = rng.random((n, 64)) < density
    blocks[mask] = rng.integers(-amp, amp + 1, size=mask.sum())
    blocks[:, 0] = rng.integers(-900, 900, size=n)  # DC diffs
    return blocks


@pytest.mark.parametrize("restart", [0, 1, 3, 16])
def test_encode_matches_numpy(rng, restart):
    blocks = _random_blocks(rng, 60)
    tbl = (rng.random(60) < 0.3).astype(np.int64)
    huff = huffman.standard_tables()
    a = encode_np.encode_scan(blocks, tbl, tbl, huff,
                              restart_interval=restart, blocks_per_mcu=1)
    b = native.encode_scan(blocks, tbl, huff,
                           restart_interval=restart, blocks_per_mcu=1)
    assert a == b


def test_encode_matches_numpy_extremes(rng):
    blocks = np.zeros((8, 64), dtype=np.int64)
    blocks[0, 0] = 2047
    blocks[1, 0] = -2047
    blocks[2, 63] = 1
    blocks[3, 1] = 1023
    blocks[3, 62] = -1023
    blocks[5] = 1
    tbl = np.zeros(8, dtype=np.int64)
    huff = huffman.standard_tables()
    assert (encode_np.encode_scan(blocks, tbl, tbl, huff)
            == native.encode_scan(blocks, tbl, huff))


@pytest.mark.parametrize("restart", [0, 2, 7])
def test_decode_matches_numpy(rng, restart):
    blocks = _random_blocks(rng, 48)
    # legal DPCM stream: treat [:,0] as diffs directly
    tbl = np.zeros(48, dtype=np.int64)
    huff = huffman.standard_tables()
    scan = encode_np.encode_scan(blocks, tbl, tbl, huff,
                                 restart_interval=restart, blocks_per_mcu=4)
    layout = [(0, 4, 0, 0)]
    luts = {k: decode_np.make_decode_lut(t) for k, t in huff.items()}
    a = decode_np.decode_scan(scan, 12, layout, luts, restart)
    b = native.decode_scan(scan, 12, layout, huff, restart)
    np.testing.assert_array_equal(a[0], b[0])


def test_decode_multicomponent(rng):
    n_mcu = 10
    layout = [(0, 4, 0, 0), (1, 1, 1, 1), (2, 1, 1, 1)]
    blocks = _random_blocks(rng, n_mcu * 6, density=0.15)
    tbl = np.tile(np.array([0, 0, 0, 0, 1, 1], dtype=np.int64), n_mcu)
    huff = huffman.standard_tables()
    scan = encode_np.encode_scan(blocks, tbl, tbl, huff,
                                 restart_interval=2, blocks_per_mcu=6)
    luts = {k: decode_np.make_decode_lut(t) for k, t in huff.items()}
    a = decode_np.decode_scan(scan, n_mcu, layout, luts, 2)
    b = native.decode_scan(scan, n_mcu, layout, huff, 2)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


def test_end_to_end_native_vs_numpy(photo, monkeypatch):
    """Full encode with native on vs off must be byte-identical; decode too."""
    jpg_native = encode(photo, quality=80, subsampling="420", restart_interval=4)
    out_native = decode(jpg_native)
    monkeypatch.setenv("JPEG_TPU_NATIVE", "0")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", True)
    jpg_np = encode(photo, quality=80, subsampling="420", restart_interval=4)
    out_np = decode(jpg_np)
    assert jpg_native == jpg_np
    np.testing.assert_array_equal(out_native, out_np)


def test_corrupt_stream_raises(rng):
    huff = huffman.standard_tables()
    with pytest.raises(ValueError):
        native.decode_scan(b"\x00\x01\x02\x03", 100, [(0, 1, 0, 0)], huff, 0)


def test_native_count_frequencies_matches_numpy(rng):
    blocks = _random_blocks(rng, 50, density=0.3)
    tbl = (rng.random(50) < 0.5).astype(np.int64)
    rec = encode_np.build_records(blocks, tbl, tbl)
    a = encode_np.count_frequencies(rec)
    b = native.count_frequencies(blocks, tbl)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=str(k))


def test_native_finalize_scan_matches_numpy(rng):
    """jt_finalize_scan is byte-identical to the NumPy finalize_segment +
    RST-marker join across segment counts, 0xFF-dense words, ragged bit
    totals (including byte-aligned and nbits%8 != 0) and rst_base offsets."""
    from jpeg_tpu.ops import bitpack

    for nseg, W, rst_base in ((1, 7, 0), (3, 32, 0), (8, 64, 5), (12, 9, 2)):
        words = rng.integers(0, 1 << 32, (nseg, W), dtype=np.uint64).astype(
            np.uint32)
        # make 0xFF bytes (stuffing) common
        ffmask = rng.random((nseg, W)) < 0.3
        words[ffmask] |= np.uint32(0xFF000000)
        totals = rng.integers(1, W * 32 + 1, nseg)
        totals[0] = W * 32  # full buffer
        if nseg > 1:
            totals[1] = 8  # single byte
        expect_parts = []
        for s in range(nseg):
            expect_parts.append(
                bitpack.finalize_segment(words[s], int(totals[s])).tobytes())
            if s != nseg - 1:
                expect_parts.append(bytes([0xFF, 0xD0 + ((rst_base + s) & 7)]))
        expect = b"".join(expect_parts)
        got = native.finalize_scan(words, totals, rst_base)
        assert got == expect


def test_native_pack_payload_matches_numpy(rng, photo):
    """jt_pack_payload is byte-exact vs the NumPy build_payload across Sp/Ep
    bucket shapes, exception-heavy values and DC-diff exceptions."""
    from jpeg_tpu import encode
    from jpeg_tpu.entropy import decode_device
    from jpeg_tpu.io import jfif
    from jpeg_tpu.models import layout as L

    for q in (75, 95):
        jpg = encode(photo, quality=q, subsampling="420", restart_interval=5)
        info = jfif.parse_jpeg(jpg)
        cy = info.components[0]
        n_mcu = L.ceil_div(info.height, 8 * cy.v) * L.ceil_div(
            info.width, 8 * cy.h)
        ml = [(i, c.h * c.v, c.dc_id, c.ac_id)
              for i, c in enumerate(info.components)]
        w = native.sparse_scan(info.scan_data, n_mcu, ml, info.htables,
                               info.restart_interval)
        Sp = decode_device.sparse_bucket(w[0].shape[0])
        Ep = decode_device.exception_bucket(
            int(np.count_nonzero(np.abs(w[0].astype(np.int32)) > 7)))
        Edp = decode_device.exception_bucket(
            decode_device.dc_diff_exceptions(w[3]))
        a = native.pack_payload(*w, Sp, Ep, Edp)
        orig = native.available
        native.available = lambda: False
        try:
            b = decode_device.build_payload(*w, Sp, Ep, Edp)
        finally:
            native.available = orig
        np.testing.assert_array_equal(a, b, err_msg=f"q={q}")
