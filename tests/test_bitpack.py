"""Device-side bit packer: byte-exact differential vs host codecs."""

import numpy as np
import pytest

import jax.numpy as jnp

from jpeg_tpu import decode, encode
from jpeg_tpu.entropy import encode_np, huffman
from jpeg_tpu.ops import bitpack


def _random_blocks(rng, n, density=0.25):
    blocks = np.zeros((n, 64), dtype=np.int32)
    mask = rng.random((n, 64)) < density
    blocks[mask] = rng.integers(-300, 301, size=mask.sum())
    blocks[:, 0] = rng.integers(-1000, 1000, size=n)
    return blocks


@pytest.mark.parametrize("density", [0.0, 0.1, 0.6, 1.0])
def test_device_pack_matches_numpy(rng, density):
    blocks = _random_blocks(rng, 40, density)
    tbl = (rng.random(40) < 0.4).astype(np.int32)
    huff = huffman.standard_tables()

    expect = encode_np.encode_scan(blocks, tbl, tbl, huff)

    luts = tuple(jnp.asarray(a) for a in bitpack.luts_from_tables(huff))
    bits, nbits = bitpack.build_bitfields(jnp.asarray(blocks), jnp.asarray(tbl), *luts)
    words, total, ok = bitpack.pack_bits(bits, nbits, 40 * 54 + 2)
    if density >= 0.6:
        assert not bool(ok)  # dense blocks exceed the per-block device cap
        return
    assert bool(ok)
    got = bitpack.finalize_segment(np.asarray(words), int(total)).tobytes()
    assert got == expect


def test_level2_tree_or_matches_segment_sum(rng):
    """Round-4 level 2 (log-depth shift-OR tree) is word-identical to the
    round-3 sorted segment-sum on the same level-1 buffers, for both packers
    and across group counts that exercise the power-of-2 padding."""
    huff = huffman.standard_tables()
    luts = tuple(jnp.asarray(a) for a in bitpack.luts_from_tables(huff))
    n_ok = 0
    for n, bpm in ((6, 6), (37 * 6, 6), (40, 4), (1, 1), (5, 1)):
        blocks = _random_blocks(rng, n, density=0.1)
        tbl = (rng.random(n) < 0.4).astype(np.int32)
        bits, nbits = bitpack.build_bitfields(
            jnp.asarray(blocks), jnp.asarray(tbl), *luts)
        nwords = n * 9 + 2
        a = bitpack.pack_bits(bits, nbits, nwords, level2="tree_or")
        b = bitpack.pack_bits(bits, nbits, nwords, level2="segment_sum")
        assert int(a[1]) == int(b[1]) and bool(a[2]) == bool(b[2])
        if bool(a[2]):  # identity is the contract only for in-budget streams
            n_ok += 1
            np.testing.assert_array_equal(np.asarray(a[0]), np.asarray(b[0]))
        if n % bpm == 0:
            c = bitpack.pack_bits_tree(bits, nbits, nwords, bpm,
                                       level2="tree_or")
            d = bitpack.pack_bits_tree(bits, nbits, nwords, bpm,
                                       level2="segment_sum")
            assert int(c[1]) == int(d[1]) and bool(c[2]) == bool(d[2])
            if bool(c[2]):
                np.testing.assert_array_equal(np.asarray(c[0]),
                                              np.asarray(d[0]))
        # level-1 formulations (in-block shift-OR tree vs masked reduce)
        e = bitpack.pack_bits(bits, nbits, nwords, level1="mask")
        assert int(e[1]) == int(a[1]) and bool(e[2]) == bool(a[2])
        if bool(a[2]):
            np.testing.assert_array_equal(np.asarray(e[0]), np.asarray(a[0]))
    assert n_ok >= 3  # the identity must actually be exercised


def test_tree_pack_matches_mcu_and_block_grouping(rng):
    """pack_bits_tree (narrow level 1 + block->MCU combine) is byte-identical
    to pack_bits under both groupings when all budgets hold, and flags ok
    consistently with its tighter per-block cap."""
    bpm, nm = 6, 37
    n = bpm * nm
    blocks = _random_blocks(rng, n, density=0.06)
    tbl = np.tile(np.array([0, 0, 0, 0, 1, 1], np.int32), nm)
    huff = huffman.standard_tables()
    luts = tuple(jnp.asarray(a) for a in bitpack.luts_from_tables(huff))
    bits, nbits = bitpack.build_bitfields(
        jnp.asarray(blocks), jnp.asarray(tbl), *luts)
    nwords = n * 12 + 2
    mw = 40  # roomy budget so uniform-density random MCUs fit
    w_m, t_m, ok_m = bitpack.pack_bits(
        bits.reshape(nm, -1), nbits.reshape(nm, -1), nwords, mw)
    w_t, t_t, ok_t = bitpack.pack_bits_tree(
        bits, nbits, nwords, bpm, mcu_words=mw)
    w_b, t_b, ok_b = bitpack.pack_bits(bits, nbits, nwords)
    assert bool(ok_m) and bool(ok_t) and bool(ok_b)
    assert int(t_m) == int(t_t) == int(t_b)
    np.testing.assert_array_equal(np.asarray(w_m), np.asarray(w_t))
    np.testing.assert_array_equal(np.asarray(w_m), np.asarray(w_b))

    # A block past the 288-bit cap: tree must report failure like "block".
    dense = _random_blocks(rng, n, density=0.9)
    db, dn = bitpack.build_bitfields(
        jnp.asarray(dense), jnp.asarray(tbl), *luts)
    _, _, ok_dense = bitpack.pack_bits_tree(db, dn, n * 54 + 2, bpm,
                                            mcu_words=120)
    assert not bool(ok_dense)


def test_tree_pack_end_to_end_stream(rng):
    """Full encoder stream through group="tree" equals the host scan, on a
    smooth gradient image (the overflow fallback is covered by
    test_device_pack_overflow_falls_back_end_to_end)."""
    from jpeg_tpu.models import encoder as E
    from jpeg_tpu.config import Subsampling
    from jpeg_tpu.ops import quant

    h, w = 128, 160
    yy, xx = np.mgrid[0:h, 0:w]
    img = np.clip(
        np.stack([xx * 255 / w, yy * 255 / h, (xx + yy) * 128 / (h + w)], -1)
        + rng.integers(-8, 9, (h, w, 3)),
        0, 255,
    ).astype(np.uint8)
    expect = encode(img, quality=75, subsampling="420")
    qy = jnp.asarray(quant.luma_table(75))
    qc = jnp.asarray(quant.chroma_table(75))
    huff = huffman.standard_tables()
    luts = tuple(jnp.asarray(a) for a in bitpack.luts_from_tables(huff))
    fn = E._jit_color_packed(Subsampling.YUV420, 0, "tree")
    words, totals, ok = fn(jnp.asarray(img), qy, qc, *luts)
    assert bool(np.asarray(ok).all())
    t = int(np.asarray(totals)[0])
    scan = bitpack.finalize_segment(
        np.asarray(words[0, : (t + 31) // 32]), t).tobytes()
    assert scan in expect


def test_device_pack_zrl_chains(rng):
    """Blocks forcing 1, 2 and 3 ZRL symbols (the split-channel paths)."""
    blocks = np.zeros((4, 64), dtype=np.int32)
    blocks[0, 20] = 5   # run 19 -> 1 ZRL
    blocks[1, 40] = -7  # run 39 -> 2 ZRLs
    blocks[2, 63] = 3   # run 62 -> 3 ZRLs
    blocks[3, 1] = 1
    blocks[3, 63] = -1  # run 61 -> 3 ZRLs
    tbl = np.array([0, 1, 0, 1], dtype=np.int32)
    huff = huffman.standard_tables()
    expect = encode_np.encode_scan(blocks, tbl, tbl, huff)
    luts = tuple(jnp.asarray(a) for a in bitpack.luts_from_tables(huff))
    bits, nbits = bitpack.build_bitfields(jnp.asarray(blocks), jnp.asarray(tbl), *luts)
    words, total, ok = bitpack.pack_bits(bits, nbits, 4 * 54 + 2)
    assert bool(ok)
    got = bitpack.finalize_segment(np.asarray(words), int(total)).tobytes()
    assert got == expect


@pytest.mark.parametrize("restart", [0, 2])
def test_encode_device_pack_end_to_end(photo, restart):
    """encode(device_pack=True) must produce byte-identical files to the host
    path (standard tables)."""
    a = encode(photo, quality=80, subsampling="420", restart_interval=restart,
               device_pack=True)
    b = encode(photo, quality=80, subsampling="420", restart_interval=restart,
               device_pack=False)
    assert a == b
    assert decode(a).shape == photo.shape


def test_device_pack_unaligned_restart_falls_back(photo):
    """n_mcu not divisible by r -> must silently use the host packer."""
    jpg = encode(photo, quality=80, subsampling="420", restart_interval=7,
                 device_pack=True)
    ref = encode(photo, quality=80, subsampling="420", restart_interval=7,
                 device_pack=False)
    assert jpg == ref


def test_bits_per_block_predicts_scan_size(rng):
    """ops.symbols.bits_per_block must equal the packed bit count exactly."""
    import jax.numpy as jnp
    from jpeg_tpu.ops import symbols

    blocks = _random_blocks(rng, 24, 0.2)
    tbl = np.zeros(24, dtype=np.int32)
    huff = huffman.standard_tables()
    dc_len = jnp.asarray(huff[(0, 0)].size.astype(np.int32))
    ac_len = jnp.asarray(huff[(1, 0)].size.astype(np.int32))
    predicted = int(np.asarray(
        symbols.bits_per_block(jnp.asarray(blocks), dc_len, ac_len)).sum())
    luts = tuple(jnp.asarray(a) for a in bitpack.luts_from_tables(huff))
    bits, nbits = bitpack.build_bitfields(jnp.asarray(blocks), jnp.asarray(tbl), *luts)
    assert predicted == int(np.asarray(nbits).sum())


def test_device_pack_optimized_tables_matches_host(photo):
    """Two-pass device path (device histograms -> optimal tables -> cached
    packed program) must equal the host optimized-tables path byte-for-byte."""
    a = encode(photo, quality=80, subsampling="420", optimize_tables=True,
               device_pack=True)
    b = encode(photo, quality=80, subsampling="420", optimize_tables=True,
               device_pack=False)
    assert a == b
    assert decode(a).shape == photo.shape


@pytest.mark.parametrize("restart", [0, 4])
def test_gray_device_pack_matches_host(photo, restart):
    g = photo[:, :, 1]
    a = encode(g, quality=80, restart_interval=restart, device_pack=True)
    b = encode(g, quality=80, restart_interval=restart, device_pack=False)
    assert a == b


@pytest.mark.parametrize("restart", [0, 4])
def test_gray_device_pack_optimized_tables_matches_host(photo, restart):
    """Gray twin of the color two-pass flow: device
    histograms -> per-image optimal tables -> cached packed program, byte-equal
    to the host optimized-tables path."""
    g = photo[:, :, 1]
    a = encode(g, quality=80, restart_interval=restart, optimize_tables=True,
               device_pack=True)
    b = encode(g, quality=80, restart_interval=restart, optimize_tables=True,
               device_pack=False)
    assert a == b
    assert decode(a).shape == g.shape


def test_batched_packed_program_matches_single(photo):
    """The K-image vmapped device program (encoder._jit_color_packed_batch)
    must produce, per image, exactly the single-image program's words/totals
    (the dispatch-amortization path)."""
    import jax

    from jpeg_tpu.config import Subsampling
    from jpeg_tpu.models import encoder as E
    from jpeg_tpu.ops import quant, tile

    mode = Subsampling.YUV420
    imgs = np.stack([photo, photo[:, :, ::-1], 255 - photo])
    imgs = np.asarray(
        tile.pad_to_multiple(jnp.asarray(imgs).transpose(1, 2, 3, 0),
                             mode.mcu_height, mode.mcu_width)
    ).transpose(3, 0, 1, 2)
    qy = jnp.asarray(quant.luma_table(75))
    qc = jnp.asarray(quant.chroma_table(75))
    luts = tuple(jnp.asarray(a)
                 for a in bitpack.luts_from_tables(huffman.standard_tables()))
    single = E._jit_color_packed(mode, 0)
    batched = E._jit_color_packed_batch(mode, 0)
    wb, tb, okb = jax.block_until_ready(
        batched(jnp.asarray(imgs), qy, qc, *luts))
    for i in range(imgs.shape[0]):
        ws, ts, oks = single(jnp.asarray(imgs[i]), qy, qc, *luts)
        assert bool(np.asarray(okb[i]).all()) == bool(np.asarray(oks).all())
        np.testing.assert_array_equal(np.asarray(tb[i]), np.asarray(ts))
        np.testing.assert_array_equal(np.asarray(wb[i]), np.asarray(ws))


def test_device_pack_overflow_falls_back_end_to_end(rng):
    """A q=100 noise image overflows the per-block device cap; encode must
    transparently repack on the host and still match the host path."""
    img = rng.integers(0, 256, size=(32, 32, 3)).astype(np.uint8)
    a = encode(img, quality=100, subsampling="444", device_pack=True)
    b = encode(img, quality=100, subsampling="444", device_pack=False)
    assert a == b
    assert decode(a).shape == img.shape


def test_adaptive_scale_retry_keeps_q95_on_device(photo):
    """q95 content exceeds the default per-block cap (the photo fixture
    peaks near 340 bits/block against the 288-bit scale-1 cap) but the
    block-grouping retry at scale 2 must keep the pack on-device,
    byte-identical to the host packer."""
    import jax
    from jpeg_tpu.config import Subsampling
    from jpeg_tpu.models import encoder as E
    from jpeg_tpu.ops import quant, tile

    mode = Subsampling.YUV420
    img = np.asarray(tile.pad_to_multiple(
        jnp.asarray(photo), mode.mcu_height, mode.mcu_width))
    luts = tuple(jnp.asarray(a)
                 for a in bitpack.luts_from_tables(huffman.standard_tables()))
    qy = jnp.asarray(quant.luma_table(95))
    qc = jnp.asarray(quant.chroma_table(95))
    ok1 = E._jit_color_packed(mode, 0, "tree")(img, qy, qc, *luts)[2]
    ok2 = E._jit_color_packed(mode, 0, "block")(img, qy, qc, *luts)[2]
    ok3 = E._jit_color_packed(mode, 0, "block", 2)(
        img, qy, qc, *luts)[2]
    assert not bool(np.asarray(ok1).all())  # default budgets overflow...
    assert not bool(np.asarray(ok2).all())
    assert bool(np.asarray(ok3).all())      # ...the scale-2 retry rescues
    a = encode(photo, quality=95, subsampling="420", device_pack=True)
    b = encode(photo, quality=95, subsampling="420", device_pack=False)
    assert a == b


def test_q95_dense_hint_single_dispatch(photo, monkeypatch):
    """One-pass budget selection: encode(quality=95) predicts dense content
    from the quantizer and dispatches the scale-2 tree program FIRST — zero
    failed scale-1 dispatches. The spy records every packed-program
    selection the encoder makes."""
    from jpeg_tpu.models import encoder as E

    calls = []
    orig = E._jit_color_packed.__wrapped__  # un-cached builder

    def spy(mode, r, group="tree", scale=1):
        calls.append((group, scale))
        return orig(mode, r, group, scale)

    monkeypatch.setattr(E, "_jit_color_packed", spy)
    a = encode(photo, quality=95, subsampling="420", device_pack=True)
    # ONE dispatch, straight to the scale-2 program (the fixture's q95 MCUs
    # peak near 1420 bits < the dense rung's 6*192*2 budget).
    assert calls == [("tree", 2)], calls
    calls.clear()
    encode(photo, quality=75, subsampling="420", device_pack=True)
    # Photographic q75 (MCUs peak near 580 bits) fits the bpm*160-bit
    # scale-1 budget in one dispatch.
    assert calls == [("tree", 1)], calls
    assert a == encode(photo, quality=95, subsampling="420",
                       device_pack=False)


def test_encode_batched_matches_per_image(photo):
    """Public encode_batched == per-image encode() bytes, on both the
    per-image fallback and the forced batched-program path."""
    from jpeg_tpu import encode_batched

    imgs = np.stack([photo, 255 - photo])
    want = [encode(im, quality=80, subsampling="420") for im in imgs]
    outs = encode_batched(imgs, quality=80, subsampling="420")
    outs_dev = encode_batched(imgs, quality=80, subsampling="420",
                              device_pack=True)
    assert outs == want and outs_dev == want
    assert decode(outs[0]).shape == imgs[0].shape


def test_encode_batched_restart_matches_encode(rng):
    """restart_interval flows through the batched program (aligned) and the
    per-image fallback (unaligned)."""
    from jpeg_tpu import encode_batched

    imgs = rng.integers(0, 255, (2, 48, 64, 3)).astype(np.uint8)
    for r in (3, 7):  # 3 divides the 12-MCU frame; 7 does not (fallback)
        want = [encode(im, quality=80, subsampling="420", restart_interval=r)
                for im in imgs]
        assert encode_batched(imgs, quality=80, subsampling="420",
                              restart_interval=r, device_pack=True) == want


def test_encode_batched_odd_size_matches_encode(rng):
    """Non-MCU-aligned (H, W): the batched edge-pad must match encode()'s
    pad on both the fallback and the forced batched path."""
    from jpeg_tpu import encode_batched

    imgs = rng.integers(0, 255, (2, 37, 53, 3)).astype(np.uint8)
    want = [encode(im, quality=80, subsampling="420") for im in imgs]
    assert encode_batched(imgs, quality=80, subsampling="420") == want
    assert encode_batched(imgs, quality=80, subsampling="420",
                          device_pack=True) == want


def test_encode_batched_float_input_matches_encode(rng):
    """Float input follows encode()'s round-then-clip convention (truncation
    once produced different bytes — r4 review finding)."""
    from jpeg_tpu import encode_batched

    img = rng.uniform(0, 255, (24, 32, 3))  # non-integral floats
    out = encode_batched(img[None], quality=80, subsampling="444")[0]
    assert out == encode(img, quality=80, subsampling="444")
