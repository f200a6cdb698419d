"""Device (jitted, vmapped-over-restart-segments) Huffman scan decoder.

Invariant under test: the device backend is bit-identical to the NumPy and
C++ backends on every stream class we decode — our own streams (all
subsamplings, restarts, optimized tables, grayscale, multi-scan) and foreign
libjpeg streams. SURVEY.md §4 item (b)/(c); DESIGN.md §6 roadmap item
"Device Huffman decode".
"""

import io

import numpy as np
import pytest
from PIL import Image

from jpeg_tpu.entropy import decode_device, decode_np
from jpeg_tpu.entropy.decode_np import ScanDecodeError
from jpeg_tpu.io import jfif
from jpeg_tpu.models import encoder
from jpeg_tpu.models.decoder import decode


def _scan_blocks(data: bytes, entropy: str):
    """Decode only the entropy layer of an interleaved 3-component stream."""
    from jpeg_tpu.models import layout
    from jpeg_tpu.models.decoder import _decode_scan

    info = jfif.parse_jpeg(data)
    cy, ccb, ccr = info.components
    mcu_rows = layout.ceil_div(info.height, 8 * cy.v)
    mcu_cols = layout.ceil_div(info.width, 8 * cy.h)
    mcu_layout = [
        (0, cy.h * cy.v, cy.dc_id, cy.ac_id),
        (1, 1, ccb.dc_id, ccb.ac_id),
        (2, 1, ccr.dc_id, ccr.ac_id),
    ]
    return _decode_scan(info, mcu_rows * mcu_cols, mcu_layout, entropy)


@pytest.mark.parametrize("mode", ["4:4:4", "4:2:2", "4:2:0"])
@pytest.mark.parametrize("restart", [0, 7])
def test_device_matches_numpy_scan_layers(photo, mode, restart):
    data = encoder.encode(photo, quality=75, subsampling=mode,
                          restart_interval=restart)
    ref = _scan_blocks(data, "numpy")
    dev = _scan_blocks(data, "device")
    for a, b in zip(ref, dev):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("mode", ["4:4:4", "4:2:0"])
def test_decode_entropy_device_pixel_identical(photo, mode):
    data = encoder.encode(photo, quality=85, subsampling=mode,
                          restart_interval=4)
    np.testing.assert_array_equal(
        decode(data, entropy="device"), decode(data, entropy="numpy")
    )


def test_device_grayscale_and_optimized_tables(photo):
    data = encoder.encode(photo[..., 0], quality=70, optimize_tables=True,
                          restart_interval=6)
    np.testing.assert_array_equal(
        decode(data, entropy="device"), decode(data, entropy="numpy")
    )


def test_device_short_tail_segment_optimized_tables(photo):
    """300 MCUs at restart interval 8 leave a 4-MCU tail segment whose
    masked MCUs decode zero padding; under optimized tables that padding
    reads as an out-of-range AC run, which must not flag the clean stream
    as corrupt."""
    data = encoder.encode(photo, quality=75, optimize_tables=True,
                          restart_interval=8)
    np.testing.assert_array_equal(
        decode(data, entropy="device"), decode(data, entropy="numpy")
    )


def test_device_foreign_pil_stream(photo):
    buf = io.BytesIO()
    Image.fromarray(photo).save(buf, format="JPEG", quality=80,
                                restart_marker_blocks=8)
    data = buf.getvalue()
    np.testing.assert_array_equal(
        decode(data, entropy="device"), decode(data, entropy="numpy")
    )


def test_device_noninterleaved_multiscan(photo):
    from jpeg_tpu.models.multiscan import encode_noninterleaved

    data = encode_noninterleaved(photo, quality=75)
    np.testing.assert_array_equal(
        decode(data, entropy="device"), decode(data, entropy="numpy")
    )


def test_device_corrupt_stream_flags_error(photo):
    data = bytearray(encoder.encode(photo, quality=75, optimize_tables=True,
                                    restart_interval=8))
    info = jfif.parse_jpeg(bytes(data))
    # Flip bits mid-scan: optimized tables leave unassigned code space, so a
    # corrupted window can hit an invalid code; the device backend must raise
    # or agree with the NumPy backend (never hang or read out of bounds).
    start = bytes(data).find(info.scan_data)
    for off in (64, 301, 777):
        trial = bytearray(data)
        trial[start + off] ^= 0x55
        if trial[start + off] == 0xFF or data[start + off] == 0xFF:
            continue  # would create/destroy a marker, changing segmentation
        try:
            a = decode(bytes(trial), entropy="device")
        except (ScanDecodeError, jfif.JpegFormatError):
            with pytest.raises((ScanDecodeError, jfif.JpegFormatError)):
                decode(bytes(trial), entropy="numpy")
            continue
        b = decode(bytes(trial), entropy="numpy")
        np.testing.assert_array_equal(a, b)


# --- hybrid backends: "indexed" (host index pass + parallel device block
# decode) and "sparse" (host sparse-coefficient walk + device densify) ------

HYBRID = ["indexed", "sparse"]


@pytest.mark.parametrize("backend", HYBRID)
@pytest.mark.parametrize("mode", ["4:4:4", "4:2:2", "4:2:0"])
@pytest.mark.parametrize("restart", [0, 7])
def test_hybrid_matches_numpy_scan_layers(photo, backend, mode, restart):
    data = encoder.encode(photo, quality=75, subsampling=mode,
                          restart_interval=restart)
    ref = _scan_blocks(data, "numpy")
    idx = _scan_blocks(data, backend)
    for a, b in zip(ref, idx):
        np.testing.assert_array_equal(a, np.asarray(b))


@pytest.mark.parametrize("backend", HYBRID)
@pytest.mark.parametrize("quality", [10, 75, 97])
def test_hybrid_pixel_identical(photo, backend, quality):
    data = encoder.encode(photo, quality=quality, subsampling="4:2:0",
                          restart_interval=4)
    np.testing.assert_array_equal(
        decode(data, entropy=backend), decode(data, entropy="numpy")
    )


@pytest.mark.parametrize("backend", HYBRID)
def test_hybrid_grayscale_and_optimized_tables(photo, backend):
    data = encoder.encode(photo[..., 0], quality=70, optimize_tables=True,
                          restart_interval=6)
    np.testing.assert_array_equal(
        decode(data, entropy=backend), decode(data, entropy="numpy")
    )


@pytest.mark.parametrize("backend", HYBRID)
def test_hybrid_foreign_pil_stream(photo, backend):
    buf = io.BytesIO()
    Image.fromarray(photo).save(buf, format="JPEG", quality=80,
                                restart_marker_blocks=8)
    data = buf.getvalue()
    np.testing.assert_array_equal(
        decode(data, entropy=backend), decode(data, entropy="numpy")
    )


@pytest.mark.parametrize("backend", HYBRID)
def test_hybrid_noninterleaved_multiscan(photo, backend):
    from jpeg_tpu.models.multiscan import encode_noninterleaved

    data = encode_noninterleaved(photo, quality=75)
    np.testing.assert_array_equal(
        decode(data, entropy=backend), decode(data, entropy="numpy")
    )


@pytest.mark.parametrize("backend", HYBRID)
def test_hybrid_corrupt_stream_flags_error(photo, backend):
    data = bytearray(encoder.encode(photo, quality=75, optimize_tables=True,
                                    restart_interval=8))
    info = jfif.parse_jpeg(bytes(data))
    start = bytes(data).find(info.scan_data)
    for off in (64, 301, 777):
        trial = bytearray(data)
        trial[start + off] ^= 0x55
        if trial[start + off] == 0xFF or data[start + off] == 0xFF:
            continue
        try:
            a = decode(bytes(trial), entropy=backend)
        except (ScanDecodeError, jfif.JpegFormatError):
            with pytest.raises((ScanDecodeError, jfif.JpegFormatError)):
                decode(bytes(trial), entropy="numpy")
            continue
        b = decode(bytes(trial), entropy="numpy")
        np.testing.assert_array_equal(a, b)


def test_sparse_fused_scaled_and_device_output(photo):
    """entropy="sparse" routes interleaved color streams through the fused
    one-program path (densify+reorder+finish in one jit) — it must honor
    scale_denom and device_output and stay bit-identical to numpy."""
    import jax.numpy as jnp

    data = encoder.encode(photo, quality=80, subsampling="4:2:0",
                          restart_interval=5)
    for sd in (1, 4):
        np.testing.assert_array_equal(
            decode(data, entropy="sparse", scale_denom=sd),
            decode(data, entropy="numpy", scale_denom=sd),
        )
    out = decode(data, entropy="sparse", device_output=True)
    assert isinstance(out, jnp.ndarray)
    np.testing.assert_array_equal(np.asarray(out), decode(data, entropy="numpy"))
    # Gray fused twin, scaled and unscaled.
    g = encoder.encode(photo[..., 1], quality=70, restart_interval=3)
    for sd in (1, 2):
        np.testing.assert_array_equal(
            decode(g, entropy="sparse", scale_denom=sd),
            decode(g, entropy="numpy", scale_denom=sd),
        )


def test_decode_batched_matches_per_image(photo):
    """decode_batched: K streams through ONE vmapped fused program ==
    per-image decode, including with per-stream optimized Huffman tables and
    scaled decode."""
    from jpeg_tpu.models.decoder import decode_batched

    imgs = [photo, photo[::-1].copy(), 255 - photo]
    datas = [
        encoder.encode(im, quality=80, subsampling="4:2:0",
                       restart_interval=r, optimize_tables=opt)
        for im, r, opt in zip(imgs, (0, 5, 0), (False, False, True))
    ]
    got = decode_batched(datas)  # auto -> pipelined at K=3
    for d, g in zip(datas, got):
        np.testing.assert_array_equal(g, decode(d, entropy="numpy"))
    # Both dispatch compositions must produce identical pixels (r5: the
    # auto default pipelines per-image programs; fused is the one-vmapped-
    # program mode).
    np.testing.assert_array_equal(
        got, decode_batched(datas, batch_mode="fused"))
    with pytest.raises(ValueError):
        decode_batched(datas, batch_mode="nope")
    s4 = decode_batched(datas, scale_denom=4)
    for d, g in zip(datas, s4):
        np.testing.assert_array_equal(g, decode(d, entropy="numpy",
                                                scale_denom=4))

    with pytest.raises(ValueError):
        decode_batched(datas[:1] + [
            encoder.encode(photo, quality=50, subsampling="4:2:0")
        ])  # different quant tables
    with pytest.raises(ValueError):
        decode_batched([
            encoder.encode(photo, quality=80, subsampling="4:4:4"),
            datas[0],
        ])  # different sampling


def _swap_huffman_ids(data: bytes) -> bytes:
    """Swap Huffman table ids 0<->1 in every DHT header and SOS component
    spec. The stream stays valid and decodes identically on its own — only
    the id *assignment* differs."""
    out = bytearray(data)
    i = 2
    while i < len(out):
        assert out[i] == 0xFF
        marker = out[i + 1]
        if marker == 0xD9:
            break
        seg = (out[i + 2] << 8) | out[i + 3]
        if marker == 0xC4:  # DHT: one or more (Tc<<4|Th, counts, syms)
            j = i + 4
            end = i + 2 + seg
            while j < end:
                out[j] ^= 1  # Th 0<->1
                n = sum(out[j + 1 : j + 17])
                j += 17 + n
        elif marker == 0xDA:  # SOS: Ns, then (Cs, Td<<4|Ta) per component
            ns = out[i + 4]
            for c in range(ns):
                out[i + 6 + 2 * c] ^= 0x11  # Td and Ta both 0<->1
            break  # entropy-coded data follows; nothing else to patch
        i += 2 + seg
    return bytes(out)


def test_decode_batched_rejects_swapped_table_ids(photo):
    """A stream with Huffman table ids swapped 0<->1 decodes identically on
    its own but must NOT batch with a normal stream: mcu_layout is built once
    from stream 0, so a mismatched id assignment would walk the second stream
    with the wrong tables (silently wrong pixels in the worst case)."""
    from jpeg_tpu.models.decoder import decode_batched

    normal = encoder.encode(photo, quality=80, subsampling="4:2:0")
    swapped = _swap_huffman_ids(normal)
    assert swapped != normal
    np.testing.assert_array_equal(
        decode(swapped, entropy="numpy"), decode(normal, entropy="numpy")
    )
    with pytest.raises(ValueError, match="homogeneous"):
        decode_batched([normal, swapped])


def test_sparse_scan_payload_contract(photo):
    """native.sparse_scan's (vals, ks, counts, dc) reassemble into exactly the
    dense blocks the full native decoder produces."""
    from jpeg_tpu.entropy import native
    from jpeg_tpu.models import layout

    data = encoder.encode(photo, quality=75, subsampling="4:2:0",
                          restart_interval=9)
    info = jfif.parse_jpeg(data)
    cy, ccb, ccr = info.components
    n_mcu = layout.ceil_div(info.height, 8 * cy.v) * layout.ceil_div(
        info.width, 8 * cy.h
    )
    mcu_layout = [
        (0, cy.h * cy.v, cy.dc_id, cy.ac_id),
        (1, 1, ccb.dc_id, ccb.ac_id),
        (2, 1, ccr.dc_id, ccr.ac_id),
    ]
    vals, ks, counts, dc = native.sparse_scan(
        info.scan_data, n_mcu, mcu_layout, info.htables,
        info.restart_interval,
    )
    assert vals.shape == ks.shape and counts.sum() == vals.shape[0]
    B = counts.shape[0]
    dense = np.zeros((B, 64), dtype=np.int32)
    dense[:, 0] = dc
    block_id = np.repeat(np.arange(B), counts)
    dense[block_id, ks.astype(np.int64)] = vals
    ref = np.concatenate(
        native.decode_scan(info.scan_data, n_mcu, mcu_layout, info.htables,
                           info.restart_interval)
    )
    np.testing.assert_array_equal(dense, ref)


def test_device_rejects_bad_segment_count(photo):
    data = encoder.encode(photo, quality=75, restart_interval=5)
    info = jfif.parse_jpeg(data)
    from jpeg_tpu.models import layout
    cy = info.components[0]
    n_mcu = layout.ceil_div(info.height, 8 * cy.v) * layout.ceil_div(
        info.width, 8 * cy.h
    )
    with pytest.raises(ScanDecodeError):
        decode_device.decode_scan(
            info.scan_data, n_mcu,
            [(0, cy.h * cy.v, cy.dc_id, cy.ac_id)], info.htables, 0
        )


def test_unknown_entropy_backend_rejected(photo):
    data = encoder.encode(photo, quality=75)
    with pytest.raises(ValueError):
        decode(data, entropy="gpu")


def test_sparse_payload_from_blocks_roundtrip(photo):
    """r5: dense raster coefficient grids -> sparse payload -> densify must
    reproduce the grids exactly (the progressive/host-entropy decode paths
    ride this conversion onto the fused sparse program, turning a ~50 MB
    dense coefficient upload into the ~1.3 MB payload)."""
    import jax.numpy as jnp

    from jpeg_tpu.entropy import decode_device as dd
    from jpeg_tpu.io import jfif
    from jpeg_tpu.models import layout as L

    jpg = encoder.encode(photo, quality=85, subsampling="4:2:0")
    info = jfif.parse_jpeg(jpg)
    comps = info.components
    mcu_rows = L.ceil_div(info.height, 16)
    mcu_cols = L.ceil_div(info.width, 16)
    from jpeg_tpu.models import decoder as D

    scans = D._decode_scan(
        info, mcu_rows * mcu_cols,
        [(i, c.h * c.v, c.dc_id, c.ac_id) for i, c in enumerate(comps)],
        "numpy")
    zz = [
        L.scan_to_raster(s, mcu_rows, mcu_cols, c.v, c.h)
        if c.h * c.v > 1 else s
        for c, s in zip(comps, scans)
    ]
    payload, B, Sp, Ep, Edp = dd.sparse_payload_from_blocks(
        [np.asarray(z) for z in zz])
    rows = np.asarray(dd.densify_body(jnp.asarray(payload), B, Sp, Ep, Edp))
    base = 0
    for z in zz:
        z = np.asarray(z)
        np.testing.assert_array_equal(rows[base:base + len(z)], z)
        base += len(z)


def test_zz_raster_sparse_path_pixels(photo, monkeypatch):
    """Force the sparse-upload conversion on CPU: progressive and baseline
    streams of the same image must decode to identical pixels through the
    converted path, and match the dense path exactly (same CPU finish)."""
    from jpeg_tpu.models import decoder as D
    from jpeg_tpu.models.progressive_enc import encode_progressive

    img = photo[:53, :61]
    prog = encode_progressive(img, quality=80, subsampling="420")
    base = encoder.encode(img, quality=80, subsampling="420")
    dense_prog = decode(prog)
    monkeypatch.setattr(D, "_want_sparse_upload", lambda: True)
    a = decode(prog)
    b = decode(base, entropy="numpy")
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(a, dense_prog)
