"""Device-side Huffman scan decode backends (JAX).

Three backends live here next to decode_np (host NumPy) and native (C++
thread pool): "device" (fully on-device, vmapped over restart segments),
"indexed" (host index pass + parallel device AC kernel) and "sparse" (host
sparse-coefficient walk + device densify — the accelerator default).
The original roadmap item this file completed: Huffman codes
are self-delimiting but not self-synchronizing, so decode is serial *within*
a restart segment — but every RSTn marker byte-aligns the stream and resets
the DC predictors (ITU-T T.81 §F.2.1.3.1), making segments independent. This
backend pads unstuffed segments to a common length and runs ONE jitted
program: `vmap` over segments of a `lax.scan` over MCUs, with the bounded AC
symbol loop as a `lax.while_loop` and 16-bit-window LUT gathers for code
resolution (same LUT construction as decode_np.make_decode_lut).

The reference has no decoder at all (`src/headers/jpg_decode.h` is an empty
include-guard shell — SURVEY.md component 16); its entropy stage also shows
why a serial design cannot scale (single accumulator, huffman.c:29-42).

Invalid codes never abort on device: the LUT maps unassigned windows to
symbol -1 with length 16 (guaranteed cursor progress), an error flag is
accumulated in the scan carry, and the host raises ScanDecodeError afterward
— mirroring decode_np's behavior without data-dependent control flow.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from jpeg_tpu.entropy import decode_np
from jpeg_tpu.entropy.decode_np import ScanDecodeError

_GUARD = 8  # zero guard bytes appended past every segment's end


def _device_luts(htables: dict, slots: list) -> tuple[np.ndarray, np.ndarray]:
    """Stack (sym, len) 16-bit-peek LUTs for the (is_ac, id) keys in `slots`.

    Unassigned windows get sym=-1 / len=16 so a corrupt stream still advances
    the bit cursor (no device-side infinite loop) while flagging the error.
    """
    sym = np.full((len(slots), 1 << 16), -1, dtype=np.int32)
    ln = np.full((len(slots), 1 << 16), 16, dtype=np.int32)
    for i, key in enumerate(slots):
        s, l = decode_np.make_decode_lut(htables[key])
        assigned = s >= 0
        sym[i][assigned] = s[assigned]
        ln[i][assigned] = l[assigned]
    return sym, ln


def _window(data, pos, limit):
    """Left-aligned 16-bit peek at bit cursor `pos` (clamped to the buffer)."""
    i = jnp.minimum(pos >> 3, limit)
    b = jax.lax.dynamic_slice(data, (i,), (3,))
    w24 = (b[0] << 16) | (b[1] << 8) | b[2]
    return (w24 >> (8 - (pos & 7))) & 0xFFFF


def _extend(amp, size):
    """Spec F.2.2.1 EXTEND as arithmetic (no data-dependent branches)."""
    half = jax.lax.shift_left(1, jnp.maximum(size, 1) - 1)
    full = jax.lax.shift_left(1, size)
    return jnp.where(size == 0, 0, jnp.where(amp < half, amp - full + 1, amp))


def _decode_block(data, limit, pos, pred, err, dc_sym, dc_len, ac_sym, ac_len):
    """Decode one 8x8 block starting at bit `pos`; returns (pos, pred, err, row)."""
    # --- DC ---
    w = _window(data, pos, limit)
    s = dc_sym[w]
    err = err | (s < 0)
    size = jnp.clip(s, 0, 15)
    pos = pos + dc_len[w]
    amp = _window(data, pos, limit) >> (16 - size)
    pos = pos + size
    pred = pred + _extend(amp, size)
    row = jnp.zeros((64,), jnp.int32).at[0].set(pred)

    # --- AC: bounded symbol loop; EOB sets k past the end ---
    def cond(st):
        k, _, _, _ = st
        return k < 64

    def body(st):
        k, pos, row, err = st
        w = _window(data, pos, limit)
        sym = ac_sym[w]
        err = err | (sym < 0)
        sym = jnp.maximum(sym, 0)
        pos = pos + ac_len[w]
        run, size = sym >> 4, sym & 15
        is_eob = sym == 0
        is_zrl = sym == 0xF0
        amp = _window(data, pos, limit) >> (16 - size)
        pos = pos + size
        kw = k + run  # write index for a regular (run, size) symbol
        err = err | (~is_eob & ~is_zrl & (kw > 63))
        val = _extend(amp, size)
        row = jnp.where(
            is_eob | is_zrl | (kw > 63),
            row,
            row.at[jnp.clip(kw, 0, 63)].set(val),
        )
        k = jnp.where(is_eob, 64, jnp.where(is_zrl, k + 16, kw + 1))
        return k, pos, row, err

    _, pos, row, err = jax.lax.while_loop(cond, body, (jnp.int32(1), pos, row, err))
    return pos, pred, err, row


@functools.cache
def _jit_segments(layout_key: tuple, max_mcu: int, nbytes: int):
    """Jitted decoder over (S, nbytes) padded segments.

    layout_key: tuple of (comp, bpm, dc_slot, ac_slot) with slot indices into
    the stacked LUT arrays. Returns (rows (S, max_mcu, bpm_total, 64),
    end_pos (S,), err (S,)).
    """
    ncomp = len(layout_key)

    def one_segment(data, n_valid, sym_luts, len_luts):
        limit = jnp.int32(nbytes - 3)

        def mcu_body(carry, m):
            pos, preds, err = carry
            valid = m < n_valid
            rows = []
            pos_in, preds_in, err_in = pos, preds, err
            for ci, (_comp, bpm, dc_slot, ac_slot) in enumerate(layout_key):
                for _ in range(bpm):
                    pos, pred, err, row = _decode_block(
                        data, limit, pos, preds[ci], err,
                        sym_luts[dc_slot], len_luts[dc_slot],
                        sym_luts[ac_slot], len_luts[ac_slot],
                    )
                    preds = preds.at[ci].set(pred)
                    rows.append(row)
            out = jnp.stack(rows)
            # Masked MCUs (past the tail segment's end) freeze all state,
            # the error flag included: they decode the zero padding, which
            # under optimized tables can read as an out-of-range AC run.
            pos = jnp.where(valid, pos, pos_in)
            preds = jnp.where(valid, preds, preds_in)
            err = jnp.where(valid, err, err_in)
            out = jnp.where(valid, out, jnp.zeros_like(out))
            return (pos, preds, err), out

        init = (jnp.int32(0), jnp.zeros((ncomp,), jnp.int32), jnp.bool_(False))
        (pos, _, err), rows = jax.lax.scan(
            mcu_body, init, jnp.arange(max_mcu, dtype=jnp.int32)
        )
        return rows, pos, err

    return jax.jit(jax.vmap(one_segment, in_axes=(0, 0, None, None)))


# ---------------------------------------------------------------------------
# Hybrid host-index / device-decode backend ("indexed"): the C++ runtime walks
# the scan once (destuff + per-block AC bit offset + absolute DC, ~2x lighter
# than a full decode and threaded across restart segments), then ONE jitted
# program entropy-decodes every block's AC coefficients in parallel — the
# serial-within-segment constraint disappears because each block's start
# position is known. This is the nvJPEG-style hybrid split:
# a vmapped while_loop over AC symbols with 32-bit window gathers, terminating
# at the *batch max* symbol count (~20-63 iterations) instead of walking the
# whole segment bit-serially (~100k+ iterations for restart-free streams).
# Uploads scan bytes + 8 B/block of index instead of 256 B/block of
# coefficients — the decode twin of the encoder's device bit packer.
# ---------------------------------------------------------------------------


# Local tile width: 64 words = 2048 bits covers any block (at most 64 symbols
# of <= 31 bits each = 1984 bits, plus up to 31 bits of start skew).
_TILE_W = 64


def _decode_ac_indexed(words, off, dc, slot, maxcode, mincode, valptr,
                       huffval):
    """words: (W,) uint32 big-endian destuffed scan; off: (B,) post-DC bit
    offsets; dc: (B,) absolute DC; slot: (B,) AC table row;
    maxcode/mincode/valptr: (nslots, 17) f32 canonical-code tables (T.81
    F.16 DECODE); huffval: (256, nslots) f32 symbol values in canonical
    order. -> (B, 64) int32 zig-zag blocks.

    GATHER-FREE inner loop: instead of a per-iteration pairs[pos>>5] row
    gather and 64K-LUT gather, each block pre-gathers its 64-word tile ONCE
    (one large fast gather); the loop then selects its window by one-hot over
    tile lanes, resolves the code length with 16 canonical maxcode compares
    (no LUT), and maps the canonical index to the symbol with a one-hot
    dot — every per-iteration op is elementwise or a matmul. Assumes the
    stream was already validated (by the host index pass or the prefix
    index); unassigned windows terminate the block like the old LUT's
    invalid->EOB mapping."""
    B = off.shape[0]
    HI = jax.lax.Precision.HIGHEST
    rows0 = jnp.zeros((B, 64), jnp.int32).at[:, 0].set(dc)
    kcol = jnp.arange(64, dtype=jnp.int32)[None, :]

    base = off >> 5  # first word of each block's tile
    nw = words.shape[0]
    tidx = jnp.clip(base[:, None] + jnp.arange(_TILE_W, dtype=jnp.int32), 0,
                    nw - 1)
    tile = words[tidx]  # (B, _TILE_W) uint32 — one large gather, outside loop

    # Per-block canonical tables resolved once via exact one-hot dots
    # (values <= 65535 are f32-exact; HIGHEST keeps the products exact).
    nslots = maxcode.shape[0]
    oh_slot = jax.nn.one_hot(slot, nslots, dtype=jnp.float32)

    def sel(tab):
        return jax.lax.dot_general(
            oh_slot, tab, (((1,), (0,)), ((), ())),
            precision=HI, preferred_element_type=jnp.float32)

    mc = sel(maxcode).astype(jnp.int32)   # (B, 17); -1 where no codes
    mn = sel(mincode).astype(jnp.int32)
    vp = sel(valptr).astype(jnp.int32)
    lane = jnp.arange(_TILE_W, dtype=jnp.int32)[None, :]
    l_iota = jnp.arange(1, 17, dtype=jnp.int32)[None, :]  # lengths 1..16

    def cond(st):
        k = st[0]
        return ~jnp.all(k >= 64)

    def one_symbol(k, pos, rows):
        rel = (pos >> 5) - base
        w0 = jnp.sum(jnp.where(lane == rel[:, None], tile, jnp.uint32(0)),
                     axis=1, dtype=jnp.uint32)
        w1 = jnp.sum(jnp.where(lane == rel[:, None] + 1, tile, jnp.uint32(0)),
                     axis=1, dtype=jnp.uint32)
        sh = (pos & 31).astype(jnp.uint32)
        win = jnp.where(
            sh == 0, w0, (w0 << sh) | (w1 >> ((jnp.uint32(32) - sh) & 31))
        )
        top = (win >> 16).astype(jnp.int32)

        # Canonical code length: smallest l with top's l-bit prefix <= maxcode.
        cl = top[:, None] >> (16 - l_iota)
        valid = (mc[:, 1:] >= 0) & (cl <= mc[:, 1:])
        any_valid = jnp.any(valid, axis=1)
        L = jnp.where(any_valid, 1 + jnp.argmax(valid, axis=1), 16)
        lsel = l_iota == L[:, None]
        cL = top >> (16 - L)
        idx = jnp.sum(jnp.where(lsel, vp[:, 1:] + cL[:, None] - mn[:, 1:], 0),
                      axis=1)
        oh_idx = jax.nn.one_hot(jnp.clip(idx, 0, 255), 256,
                                dtype=jnp.bfloat16)
        sym = jax.lax.dot_general(
            oh_idx, huffval.astype(jnp.bfloat16), (((1,), (0,)), ((), ())),
            preferred_element_type=jnp.float32)
        sym = jnp.sum(sym * oh_slot, axis=1).astype(jnp.int32)
        sym = jnp.where(any_valid, sym, 0)  # unassigned window -> EOB

        run, size = sym >> 4, sym & 15
        # code + amplitude both fit the 32-bit window (16 + 15 <= 32).
        shift = (32 - L - size).astype(jnp.uint32)
        amp = ((win >> shift) & ((jnp.uint32(1) << size.astype(jnp.uint32)) - 1)
               ).astype(jnp.int32)
        val = _extend(amp, size)
        is_eob = sym == 0
        is_zrl = sym == 0xF0
        active = k < 64
        kw = k + run
        emit = active & ~is_eob & ~is_zrl & (kw <= 63)
        rows = rows + jnp.where(
            emit[:, None] & (kcol == kw[:, None]), val[:, None], 0
        )
        pos = jnp.where(active, pos + L + size, pos)
        k = jnp.where(
            active,
            jnp.where(is_eob, 64, jnp.where(is_zrl, k + 16, kw + 1)),
            k,
        )
        return k, pos, rows

    def body(st):
        # Unrolled x4: the while_loop has a fixed per-trip overhead (cond
        # reduction + kernel launches); consuming 4 symbols per trip
        # quarters the trip count for dense blocks while idle lanes stay
        # masked by `active`.
        k, pos, rows = st
        for _ in range(4):
            k, pos, rows = one_symbol(k, pos, rows)
        return k, pos, rows

    init = (jnp.ones((B,), jnp.int32), off, rows0)
    _, _, rows = jax.lax.while_loop(cond, body, init)
    return rows


_indexed_jit = jax.jit(_decode_ac_indexed)


def _canonical_tables(htables: dict, slots: tuple):
    """(maxcode, mincode, valptr) (nslots, 17) f32 + huffval (256, nslots)
    f32 — T.81 F.16 DECODE tables for the gather-free AC kernel."""
    n = len(slots)
    maxcode = np.full((n, 17), -1.0, dtype=np.float32)
    mincode = np.zeros((n, 17), dtype=np.float32)
    valptr = np.zeros((n, 17), dtype=np.float32)
    huffval = np.zeros((256, n), dtype=np.float32)
    for i, key in enumerate(slots):
        t = htables[key]
        huffval[: len(t.vals), i] = np.asarray(t.vals, dtype=np.float32)
        code = 0
        k = 0
        for l in range(1, 17):
            cnt = int(t.bits[l - 1])
            if cnt:
                valptr[i, l] = k
                mincode[i, l] = code
                code += cnt
                k += cnt
                maxcode[i, l] = code - 1
            code <<= 1
    return maxcode, mincode, valptr, huffval


_CANON_CACHE: dict = {}


def _cached_canonical(lut_key, htables, slots):
    hit = _CANON_CACHE.get(lut_key)
    if hit is not None:
        return hit
    out = tuple(jnp.asarray(a) for a in _canonical_tables(htables, slots))
    if len(_CANON_CACHE) >= 16:
        _CANON_CACHE.clear()
    _CANON_CACHE[lut_key] = out
    return out

# Device-resident caches: AC LUTs (1 MB per table set) and per-geometry slot
# arrays are re-used across decodes instead of re-uploaded over the host link.
_AC_LUT_CACHE: dict = {}
_SLOT_CACHE: dict = {}


def _cached_ac_luts(lut_key, htables, ac_slots):
    """(len << 16) | (sym & 0xFFFF) packed per window — one device-resident
    gather table (0.5 MB per table set) instead of separate sym/len tables."""
    hit = _AC_LUT_CACHE.get(lut_key)
    if hit is not None:
        return hit
    sym = np.full((len(ac_slots), 1 << 16), -1, dtype=np.int32)
    ln = np.full((len(ac_slots), 1 << 16), 16, dtype=np.int32)
    for i, key in enumerate(ac_slots):
        s, l = decode_np.make_decode_lut(htables[key])
        assigned = s >= 0
        sym[i][assigned] = s[assigned]
        ln[i][assigned] = l[assigned]
    out = jnp.asarray((ln << 16) | (sym & 0xFFFF))
    if len(_AC_LUT_CACHE) >= 16:
        _AC_LUT_CACHE.clear()
    _AC_LUT_CACHE[lut_key] = out
    return out


def _cached_slot_array(bpm_slots, mcu_count):
    key = (bpm_slots, mcu_count)
    hit = _SLOT_CACHE.get(key)
    if hit is not None:
        return hit
    slot = jnp.asarray(np.concatenate([
        np.full(bpm * mcu_count, s, dtype=np.int32) for (bpm, s) in bpm_slots
    ]))
    if len(_SLOT_CACHE) >= 16:
        _SLOT_CACHE.clear()
    _SLOT_CACHE[key] = slot
    return slot


def decode_scan_indexed(
    scan: bytes,
    mcu_count: int,
    mcu_layout: list,
    htables: dict,
    restart_interval: int,
):
    """Hybrid backend: same contract as decode_scan but returns per-component
    DEVICE arrays (jnp), so the finishing program consumes them with no
    host round-trip. Requires the native runtime (entropy.native)."""
    from jpeg_tpu.entropy import native

    destuffed, ac_off, dc = native.index_scan(
        scan, mcu_count, mcu_layout, htables, restart_interval
    )

    ac_slots = sorted({(1, ac) for (_, _, _, ac) in mcu_layout})
    slot_of = {k: i for i, k in enumerate(ac_slots)}
    lut_key = tuple(
        (key, htables[key].size.tobytes(), htables[key].code.tobytes())
        for key in ac_slots
    )
    canon = _cached_canonical(lut_key, htables, tuple(ac_slots))
    slot_dev = _cached_slot_array(
        tuple((bpm, slot_of[(1, ac)]) for (_, bpm, _, ac) in mcu_layout),
        mcu_count,
    )

    # Big-endian words + guard, bucketed to a power of two for jit reuse.
    # Scan words, AC offsets and DCs ride ONE upload (one transfer instead
    # of three).
    nwords = 1 << max(6, (len(destuffed) // 4 + 4).bit_length())
    B = ac_off.shape[0]
    payload = np.zeros(nwords + 2 * B, dtype=np.uint32)
    payload[: (len(destuffed) + 3) // 4] = np.frombuffer(
        destuffed.tobytes() + b"\0" * (-len(destuffed) % 4), dtype=">u4"
    ).astype(np.uint32)
    payload[nwords:nwords + B] = ac_off.view(np.uint32)
    payload[nwords + B:] = dc.astype(np.int32).view(np.uint32)
    dev = jnp.asarray(payload)
    words_d = dev[:nwords]
    off_d = jax.lax.bitcast_convert_type(dev[nwords:nwords + B], jnp.int32)
    dc_d = jax.lax.bitcast_convert_type(dev[nwords + B:], jnp.int32)

    rows = _indexed_jit(words_d, off_d, dc_d, slot_dev, *canon)
    out, base = [], 0
    for (_comp, bpm, _, _) in mcu_layout:
        out.append(rows[base : base + bpm * mcu_count])
        base += bpm * mcu_count
    return out


# ---------------------------------------------------------------------------
# Sparse-coefficient backend ("sparse"): the C++ runtime resolves the whole
# entropy layer on the host in one walk (absolute DCs + nonzero ACs as
# (value, zig-zag position) pairs — native.sparse_scan), and the device runs a
# single DENSE densify program: unpack the byte payload, derive each sparse
# element's block id from the per-block counts (one sorted B-point scatter +
# cumsum), and place values with a sorted segment-sum over one-hot position
# masks — the same masked-reduce shape as the encoder's level-1 pack. No
# serial symbol chain on device at all: unlike the per-symbol while_loop
# kernel, this program is dense elementwise work on ~2 B per coefficient
# (int8 value + uint8 position; |v| > 127 via a small exception stream).
# Upload is ONE device_put (~2 MB for a 4K q75 stream vs 12 MB dense).
# ---------------------------------------------------------------------------


def _ceil16(n: int) -> int:
    return -(-n // 16) * 16


def _unpack6(words, n: int):
    """6-bit stream unpack: (G*3,) uint32 words -> (n,) int32 in [0, 64).
    16 values ride each 96-bit group; every lane is a STATIC shift (two-word
    combine for the two straddling lanes) — no gathers."""
    g = words.reshape(-1, 3)
    w = [g[:, 0], g[:, 1], g[:, 2]]
    outs = []
    for j in range(16):
        b = 6 * j
        a, s = b // 32, b % 32
        v = w[a] >> jnp.uint32(s)
        if s > 26:
            v = v | (w[a + 1] << jnp.uint32(32 - s))
        outs.append(v & jnp.uint32(63))
    return jnp.stack(outs, axis=1).reshape(-1)[:n].astype(jnp.int32)


def _unpack_nib(words, n: int):
    """Nibble stream unpack: (n/8,) uint32 -> (n,) int32 two's-complement
    4-bit values in [-8, 7]."""
    nib = jnp.stack(
        [(words >> jnp.uint32(4 * i)) & jnp.uint32(15) for i in range(8)],
        axis=1,
    ).reshape(-1)[:n].astype(jnp.int32)
    return (nib ^ 8) - 8


def _unpack_i8(words, n: int):
    """int8 byte stream unpack: (ceil(n/4),) uint32 -> (n,) int32."""
    b = jnp.stack(
        [(words >> jnp.uint32(8 * i)) & jnp.uint32(255) for i in range(4)],
        axis=1,
    ).reshape(-1)[:n].astype(jnp.int32)
    return (b ^ 0x80) - 0x80


def _exception_pairs(payload, base: int, Ep: int):
    """Decode the (idx u32, val i16) exception stream -> (idx, val) int32
    arrays (the ONE home of the exception wire format)."""
    idx = jax.lax.bitcast_convert_type(payload[base:base + Ep], jnp.int32)
    evw = payload[base + Ep:base + Ep + Ep // 2]
    eh = jnp.stack([evw & 0xFFFF, evw >> 16], axis=1).reshape(-1)
    val = (eh.astype(jnp.int32) ^ 0x8000) - 0x8000
    return idx, val


def _apply_exceptions(stream, payload, base: int, Ep: int, cap: int):
    """Add the (idx u32, val i16) exception stream onto `stream`. Sentinel'd
    slots hold 0, so the sorted add reconstructs values exactly; padding
    entries target cap-1 with value 0 (no-op adds keeping indices sorted)."""
    idx, val = _exception_pairs(payload, base, Ep)
    return stream.at[jnp.clip(idx, 0, cap - 1)].add(
        val, indices_are_sorted=True
    )


def densify_body(payload, B: int, Sp: int, Ep: int, Edp: int,
                 formulation: str = "prefix_gather"):
    """Traceable densify of the v2 sparse payload: uint32 words
    [counts 6b | ks 6b | vals 4b | dc-diff i8 | val_exc (u32+i16) |
    dc_exc (u32+i16)] -> (B, 64) int32 zig-zag blocks. Pure function of the
    payload so callers can fuse it into larger jitted programs (the decoder
    composes densify + raster reorder + finishing into ONE program, saving
    the extra dispatches).

    v2 format (sized for a bandwidth-bound host link): counts and zig-zag positions are 6-bit packed
    (both <= 63, no exceptions needed), AC values are two's-complement
    nibbles (JPEG ACs are overwhelmingly tiny; |v| > 7 rides the sentinel -8
    plus a (u32 idx, i16 val) exception), and DC uploads as int8 diffs of
    the absolute-DC array (photographic DC varies smoothly; |diff| > 127
    rides the sentinel -128 plus its own exception stream; the device
    reconstructs with one cumsum). ~48% fewer payload bytes than v1 on the
    4K q75 bench stream (2.49 -> ~1.3 MB). All unpacks are static shifts."""
    B16 = _ceil16(B)
    c6w = (B16 // 16) * 3
    k6w = (Sp // 16) * 3
    v4w = Sp // 8
    d8w = (B + 3) // 4
    off = 0
    counts = _unpack6(payload[:c6w], B)
    off += c6w
    ks = _unpack6(payload[off:off + k6w], Sp)
    off += k6w
    v4 = _unpack_nib(payload[off:off + v4w], Sp)
    vals_nib = jnp.where(v4 == -8, 0, v4)
    off += v4w
    d8 = _unpack_i8(payload[off:off + d8w], B)
    dcd = jnp.where(d8 == -128, 0, d8)
    off += d8w
    exc_off = off
    off += Ep + Ep // 2
    dcd = _apply_exceptions(dcd, payload, off, Edp, B)
    dc = jnp.cumsum(dcd)

    kcol = jnp.arange(64, dtype=jnp.int32)[None, :]
    starts = jnp.cumsum(counts) - counts

    def full_contrib():
        # Post-exception element values -> (Sp, 64) one-hot contributions
        # (the non-default formulations; prefix_gather stays int16
        # pre-exception and never builds this).
        vals = _apply_exceptions(vals_nib, payload, exc_off, Ep, Sp)
        return jnp.where(kcol == ks[:, None], vals[:, None], 0)

    if formulation == "segment_sum":
        contrib = full_contrib()
        # Scatter formulation, kept for A/B: block id per sparse element via
        # a start-offset marks scatter + cumsum, then a sorted segment-sum
        # of the one-hot contributions.
        marks = jnp.zeros((Sp,), jnp.int32).at[
            jnp.clip(starts, 0, Sp - 1)
        ].add(1, indices_are_sorted=True)
        block_id = jnp.cumsum(marks) - 1
        rows = jax.ops.segment_sum(
            contrib, block_id, num_segments=B, indices_are_sorted=True
        )
    elif formulation == "prefix_mxu":
        contrib = full_contrib()
        # prefix_gather with the column cumsum built as a TWO-LEVEL scan:
        # within-chunk prefix sums are a lower-triangular ones-matmul
        # (bf16 hi/lo 6-bit planes of the <=11-bit coefficients —
        # 0/1 x <=2^6 products with f32 accumulation over 128 terms are
        # exact), chunk offsets are a tiny cumsum over Sp/128 rows. XLA's
        # own cumsum is log2(Sp) shifted-add passes over the (Sp, 64)
        # array (~GBs of traffic); this is one matmul + one small scan.
        C = 128
        spp = -(-Sp // C) * C
        c3 = jnp.pad(contrib, ((0, spp - Sp), (0, 0))).reshape(-1, C, 64)
        hi = jax.lax.shift_right_arithmetic(c3, 6)
        lo = c3 - (hi << 6)
        tri = jnp.tril(jnp.ones((C, C), jnp.bfloat16))
        scan_hi = jnp.einsum(
            "ij,njk->nik", tri, hi.astype(jnp.bfloat16),
            preferred_element_type=jnp.float32).astype(jnp.int32)
        scan_lo = jnp.einsum(
            "ij,njk->nik", tri, lo.astype(jnp.bfloat16),
            preferred_element_type=jnp.float32).astype(jnp.int32)
        within = (scan_hi << 6) + scan_lo                  # (nc, C, 64)
        totals = within[:, -1, :]                          # (nc, 64)
        offs = jnp.cumsum(totals, axis=0) - totals         # (nc, 64)
        p = (within + offs[:, None, :]).reshape(spp, 64)[:Sp]
        p = jnp.concatenate([jnp.zeros((1, 64), contrib.dtype), p], axis=0)
        idx = jnp.concatenate([starts, starts[-1:] + counts[-1:]])
        g = jnp.take(p, idx, axis=0)
        rows = g[1:] - g[:-1]
    elif formulation == "prefix_gather":
        # Scatter-free (the default): per-block sums over CONTIGUOUS stream
        # ranges are prefix-sum differences — one column cumsum over
        # (Sp, 64) plus ONE sorted row gather. Element block membership is
        # implicit in [starts[b], starts[b] + counts[b]) — no marks
        # scatter, no block_id. Three refinements:
        #   * the whole pipeline runs in int16 on the PRE-exception nibble
        #     values (|v| <= 7, per-block sums <= 441) — half the
        #     cumsum/gather traffic; wraparound keeps differences exact;
        #     the <= Ep large-value exceptions join afterward as a tiny
        #     (block, k) scatter-add (their nibble slot holds 0);
        #   * blocks tile the stream contiguously (starts[b+1] = starts[b]
        #     + counts[b]), so one gather at [starts..., total] and a
        #     first difference replaces separate start/end gathers;
        #   * padding elements (vals 0) sit past every block's range.
        c16 = jnp.where(kcol == ks[:, None],
                        vals_nib.astype(jnp.int16)[:, None], jnp.int16(0))
        p = jnp.cumsum(c16, axis=0)
        p = jnp.concatenate([jnp.zeros((1, 64), jnp.int16), p], axis=0)
        idx = jnp.concatenate([starts, starts[-1:] + counts[-1:]])
        g = jnp.take(p, idx, axis=0)
        rows = (g[1:] - g[:-1]).astype(jnp.int32)
        # Value exceptions: sorted element ids -> (block, k) by a binary
        # search over starts + a tiny gather of ks; Ep is bucketed at a
        # few hundred, so the scatter-add is noise. Padding exceptions
        # carry value 0 (no-op adds; any k=0 target is overwritten by the
        # DC column set below).
        eidx, evals = _exception_pairs(payload, exc_off, Ep)
        eclip = jnp.clip(eidx, 0, Sp - 1)
        eblk = jnp.clip(
            jnp.searchsorted(starts, eclip, side="right") - 1, 0, B - 1)
        ek = ks[eclip]
        rows = rows.at[eblk, ek].add(evals)
    else:
        raise ValueError(f"unknown densify formulation {formulation!r}")
    # Real AC positions are 1..63, so column 0 is free for the DC.
    return rows.at[:, 0].set(dc)


@functools.cache
def _jit_densify(B: int, Sp: int, Ep: int, Edp: int):
    return jax.jit(
        functools.partial(densify_body, B=B, Sp=Sp, Ep=Ep, Edp=Edp))


def sparse_bucket(S: int) -> int:
    """Upload-size bucket for S sparse elements: 1/8-octave steps
    ((8..15) << e), strictly > S — a start offset exactly at S (empty tail
    blocks) must keep its mark past the last real element. Finer than
    power-of-two buckets because the padding is real upload bytes (<= 12.5%
    waste vs <= 100%), at ~8x the distinct jit geometries per octave — all
    persistent-cache-friendly. Always a multiple of 16 (the 6-bit pack
    granularity; floor 1024 guarantees the shift is >= 4)."""
    need = max(1024, S + 1)
    e = need.bit_length() - 4  # so that (8..16) << e covers `need`
    return -(-need >> e) << e


def exception_bucket(E: int) -> int:
    """Exception-stream bucket: same 1/8-octave shape, floor 256 (the stream
    is tiny; over-padding it costs ~1.5 KB)."""
    need = max(256, E + 1)
    e = need.bit_length() - 4
    return -(-need >> e) << e


def _pack6(a: np.ndarray) -> np.ndarray:
    """(n,) values <= 63, n % 16 == 0 -> (n/16*3,) uint32 (the _unpack6
    layout: value j of each 16-group at bits [6j, 6j+6) of its 96-bit
    group)."""
    g = a.reshape(-1, 16).astype(np.uint64)
    lo = np.zeros(g.shape[0], np.uint64)   # bits 0..63
    hi = np.zeros(g.shape[0], np.uint64)   # bits 64..95 (in low 32)
    for j in range(16):
        b = 6 * j
        if b < 64:
            lo |= g[:, j] << b
            if b > 58:  # straddles the 64-bit boundary (j == 10: bits 60..65)
                hi |= g[:, j] >> (64 - b)
        else:
            hi |= g[:, j] << (b - 64)
    out = np.empty((g.shape[0], 3), np.uint32)
    out[:, 0] = lo & 0xFFFFFFFF
    out[:, 1] = lo >> 32
    out[:, 2] = hi & 0xFFFFFFFF
    return out.reshape(-1)


def _pack_exc(payload, base: int, idx: np.ndarray, val: np.ndarray,
              Ep: int, cap: int) -> int:
    """Write one (idx u32, val i16) exception stream; padding entries target
    cap-1 with value 0. Returns the next write offset."""
    if idx.shape[0] > Ep:
        raise ValueError("exception bucket too small")
    ibuf = np.full(Ep, cap - 1, dtype=np.uint32)
    ibuf[: idx.shape[0]] = idx
    payload[base:base + Ep] = ibuf
    base += Ep
    ebuf = np.zeros(Ep, dtype=np.int16)
    ebuf[: idx.shape[0]] = val
    payload[base:base + Ep // 2] = ebuf.view(np.uint32)
    return base + Ep // 2


def dc_diff_exceptions(dc: np.ndarray) -> int:
    """Number of |diff| > 127 entries the v2 dc-diff stream needs (callers
    size the Edp bucket from this)."""
    dcd = np.diff(dc.astype(np.int32), prepend=np.int32(0))
    return int(np.count_nonzero(np.abs(dcd) > 127))


def build_payload(vals, ks, counts, dc, Sp: int, Ep: int,
                  Edp: int) -> np.ndarray:
    """Pack native.sparse_scan outputs into the v2 uint32 upload payload
    densify_body expects ([counts 6b | ks 6b | vals 4b | dc-diff i8 |
    val_exc | dc_exc]); |v| > 7 values become the nibble sentinel -8 plus an
    exception entry, |dc diff| > 127 the int8 sentinel -128 plus its own.
    Uses the C++ packer when available (the NumPy path below is the
    byte-exact reference, ~13 ms vs ~1 ms for a 4K payload)."""
    from jpeg_tpu.entropy import native

    if native.available():
        return native.pack_payload(vals, ks, counts, dc, Sp, Ep, Edp)
    B = counts.shape[0]
    S = vals.shape[0]
    B16 = -(-B // 16) * 16
    c6w = (B16 // 16) * 3
    k6w = (Sp // 16) * 3
    v4w = Sp // 8
    d8w = (B + 3) // 4

    vals32 = vals.astype(np.int32)
    big = np.abs(vals32) > 7
    vexc_i = np.nonzero(big)[0].astype(np.uint32)
    v4 = np.where(big, -8, vals32)

    dcd = np.diff(dc.astype(np.int32), prepend=np.int32(0))
    dbig = np.abs(dcd) > 127
    dexc_i = np.nonzero(dbig)[0].astype(np.uint32)
    d8 = np.where(dbig, -128, dcd).astype(np.int8)

    payload = np.zeros(c6w + k6w + v4w + d8w + Ep + Ep // 2 + Edp + Edp // 2,
                       dtype=np.uint32)
    cbuf = np.zeros(B16, dtype=np.uint8)
    cbuf[:B] = counts
    payload[:c6w] = _pack6(cbuf)
    off = c6w
    kbuf = np.zeros(Sp, dtype=np.uint8)
    kbuf[:S] = ks
    payload[off:off + k6w] = _pack6(kbuf)
    off += k6w
    nbuf = np.zeros(Sp, dtype=np.uint8)
    nbuf[:S] = (v4 & 15).astype(np.uint8)
    payload[off:off + v4w] = (
        nbuf[0::2] | (nbuf[1::2] << 4)
    ).view(np.uint32)
    off += v4w
    dbuf = np.zeros(d8w * 4, dtype=np.int8)
    dbuf[:B] = d8
    payload[off:off + d8w] = dbuf.view(np.uint32)
    off += d8w
    off = _pack_exc(payload, off, vexc_i, vals32[big].astype(np.int16),
                    Ep, Sp)
    _pack_exc(payload, off, dexc_i, dcd[dbig].astype(np.int16), Edp, B)
    return payload


def sparse_payload(
    scan: bytes,
    mcu_count: int,
    mcu_layout: list,
    htables: dict,
    restart_interval: int,
):
    """Host half of the sparse backend: run native.sparse_scan and pack its
    outputs into the single uint32 upload payload densify_body expects.
    Returns (payload (np.uint32), B, Sp, Ep, Edp)."""
    from jpeg_tpu.entropy import native

    vals, ks, counts, dc = native.sparse_scan(
        scan, mcu_count, mcu_layout, htables, restart_interval
    )
    Sp = sparse_bucket(vals.shape[0])
    E = int(np.count_nonzero(np.abs(vals.astype(np.int32)) > 7))
    Ep = exception_bucket(E)
    Edp = exception_bucket(dc_diff_exceptions(dc))
    return (build_payload(vals, ks, counts, dc, Sp, Ep, Edp),
            counts.shape[0], Sp, Ep, Edp)


def sparse_payload_from_blocks(blocks_list):
    """Build the sparse upload payload from already-decoded dense (N, 64)
    zig-zag block arrays (one per component, DC at column 0 ABSOLUTE).

    The progressive decoder's device finish uses this: its C++/NumPy
    scan walkers produce dense per-component grids, and uploading those as
    int32 coefficients costs ~50 MB for a 4K frame on the host link — the
    sparse payload is ~1.3 MB and feeds the SAME fused densify+finish
    program as the baseline path (with no scan->raster reorder, since the
    grids are already raster). Returns (payload, B, Sp, Ep, Edp)."""
    dense = np.concatenate([np.asarray(b) for b in blocks_list], axis=0)
    dense = dense.astype(np.int32, copy=False)
    ac = dense[:, 1:]
    rows, cols = np.nonzero(ac)
    vals = ac[rows, cols].astype(np.int16)
    ks = (cols + 1).astype(np.uint8)  # zig-zag position 1..63
    counts = np.bincount(rows, minlength=dense.shape[0]).astype(np.int32)
    dc = dense[:, 0].astype(np.int32)
    Sp = sparse_bucket(vals.shape[0])
    Ep = exception_bucket(int(np.count_nonzero(np.abs(
        vals.astype(np.int32)) > 7)))
    Edp = exception_bucket(dc_diff_exceptions(dc))
    return (build_payload(vals, ks, counts, dc, Sp, Ep, Edp),
            dense.shape[0], Sp, Ep, Edp)


def decode_scan_sparse(
    scan: bytes,
    mcu_count: int,
    mcu_layout: list,
    htables: dict,
    restart_interval: int,
):
    """Sparse backend: same contract as decode_scan_indexed (per-component
    DEVICE arrays). Requires the native runtime (entropy.native)."""
    payload, B, Sp, Ep, Edp = sparse_payload(
        scan, mcu_count, mcu_layout, htables, restart_interval
    )
    rows = _jit_densify(B, Sp, Ep, Edp)(jnp.asarray(payload))
    out, base = [], 0
    for (_comp, bpm, _, _) in mcu_layout:
        out.append(rows[base : base + bpm * mcu_count])
        base += bpm * mcu_count
    return out


# ---------------------------------------------------------------------------
# Parallel-prefix device index (pointer doubling) — the DESIGN sketch,
# built: restart-free streams have no parallel seam, so the serial Huffman
# chain is re-shaped as function composition over bit positions. For EVERY bit
# position p the program tabulates "advance of one AC symbol starting at p"
# (one LUT gather per position), pointer-doubles those into jump tables for
# 2^j symbols, resolves "advance of one full block" for every p by a 6-step
# binary descent (valid because k-increments are >= 1, so the prefix predicate
# 'no EOB and k <= 63' is monotone), chains blocks into "advance of one MCU"
# per position, pointer-doubles MCUs, and reads off every MCU's start bit —
# all data-parallel on device. DC differences are then gathered at the now-
# known positions, cumsum'd into absolute DCs, and the existing indexed AC
# kernel (_decode_ac_indexed) decodes every block in parallel. Exact (not
# speculative): bit-identical to the host walkers, errors composed via flags.
# ---------------------------------------------------------------------------


def _packed_dc_luts(htables: dict, dc_slots: tuple) -> np.ndarray:
    """(len << 16) | size per 16-bit window; invalid windows (no code, or a
    hostile DHT binding DC symbols > 16) carry sym -1 (low half 0xFFFF)."""
    out = np.empty((len(dc_slots), 1 << 16), dtype=np.int32)
    for i, key in enumerate(dc_slots):
        s, l = decode_np.make_decode_lut(htables[key])
        s = s.astype(np.int32)
        l = l.astype(np.int32)
        bad = (s < 0) | (s > 16)
        out[i] = (np.where(bad, 16, l) << 16) | (np.where(bad, -1, s) & 0xFFFF)
    return out


@functools.cache
def _jit_prefix_index(nbits: int, seq: tuple, n_mcu: int):
    """Jitted parallel-prefix index program.

    nbits: padded stream length in bits (power-of-two bucketed).
    seq: per-MCU block sequence of (dc_slot, ac_slot) pairs (static).
    Returns (ac_off (B,), dc_abs (B,) int32, end_pos (), err ()) with blocks
    ordered component-major (all blocks of seq-position class grouped by the
    caller)."""
    classes = sorted(set(seq))
    class_of = {c: i for i, c in enumerate(classes)}
    levels = 6  # 2^5 = 32 >= max symbols any descent step needs
    mcu_levels = max(1, (n_mcu - 1).bit_length())

    def program(bytes_u8, dc_luts, ac_luts):
        # --- 16-bit window at every bit position (elementwise, no gathers) --
        b = bytes_u8.astype(jnp.uint32)
        b1 = jnp.concatenate([b[1:], jnp.zeros((1,), jnp.uint32)])
        b2 = jnp.concatenate([b[2:], jnp.zeros((2,), jnp.uint32)])
        w24 = (b << 16) | (b1 << 8) | b2
        r = jnp.arange(8, dtype=jnp.uint32)[None, :]
        w16 = ((w24[:, None] >> (8 - r)) & 0xFFFF).reshape(-1)  # (nbits,)
        pidx = jnp.arange(nbits, dtype=jnp.int32)

        def clipg(tab, idx):
            return tab[jnp.clip(idx, 0, nbits - 1)]

        # --- per-class single-symbol AC tables -----------------------------
        fb_pos, fb_err = [], []
        for dc_slot, ac_slot in classes:
            packed = ac_luts[ac_slot, w16]
            sym = jnp.maximum((packed << 16) >> 16, -1)
            invalid = sym < 0
            symv = jnp.maximum(sym, 0)
            ln = packed >> 16
            size = symv & 15
            adv0 = jnp.where(invalid, 16, ln + size).astype(jnp.int32)
            eob = (symv == 0) & ~invalid
            zrl = symv == 0xF0
            kinc0 = jnp.where(
                eob | invalid, 0, jnp.where(zrl, 16, (symv >> 4) + 1)
            ).astype(jnp.int32)
            term0 = eob
            err0 = invalid

            # --- pointer-double AC symbols into 2^j jump tables ------------
            advs, kincs, terms, errs = [adv0], [kinc0], [term0], [err0]
            for _ in range(1, levels):
                a, k, t, e = advs[-1], kincs[-1], terms[-1], errs[-1]
                nxt = pidx + a
                advs.append(a + clipg(a, nxt))
                kincs.append(k + jnp.where(t, 0, clipg(k, nxt)))
                terms.append(t | clipg(t, nxt))
                errs.append(e | clipg(e, nxt))

            # --- DC single step for every position -------------------------
            dpacked = dc_luts[dc_slot, w16]
            dsym = (dpacked << 16) >> 16
            dinvalid = dsym < 0
            dsize = jnp.clip(dsym, 0, 16)
            dln = dpacked >> 16
            dc_adv = jnp.where(dinvalid, 16, dln + dsize).astype(jnp.int32)

            # --- block-end for every position: binary descent --------------
            p = jnp.clip(pidx + dc_adv, 0, nbits - 1)
            err = dinvalid
            k = jnp.ones((nbits,), jnp.int32)
            for j in range(levels - 1, -1, -1):
                t = terms[j][p]
                kj = kincs[j][p]
                aj = advs[j][p]
                ej = errs[j][p]
                ok = (~t) & (k + kj <= 63)
                p = jnp.where(ok, jnp.clip(p + aj, 0, nbits - 1), p)
                k = jnp.where(ok, k + kj, k)
                err = err | (ok & ej)
            # exactly one closing symbol (EOB, or the k>=64 crossing)
            err = err | errs[0][p]
            kfin = k + kincs[0][p]
            err = err | (~terms[0][p] & (kfin > 64))
            p = p + advs[0][p]
            fb_pos.append(p.astype(jnp.int32))
            fb_err.append(err)

        fb_pos = jnp.stack(fb_pos)
        fb_err = jnp.stack(fb_err)

        # --- one-MCU advance for every position ----------------------------
        cur = pidx
        merr = jnp.zeros((nbits,), bool)
        for pair in seq:
            ci = class_of[pair]
            merr = merr | fb_err[ci][jnp.clip(cur, 0, nbits - 1)]
            cur = fb_pos[ci][jnp.clip(cur, 0, nbits - 1)]
        mcu_pos0, mcu_err0 = cur, merr

        # --- pointer-double MCUs, then read off every MCU start ------------
        jumps = [mcu_pos0]
        for _ in range(1, mcu_levels):
            a = jumps[-1]
            jumps.append(clipg(a, a))
        m = jnp.arange(n_mcu, dtype=jnp.int32)
        starts = jnp.zeros((n_mcu,), jnp.int32)
        for j in range(mcu_levels):
            take = (m >> j) & 1
            starts = jnp.where(
                take == 1, jumps[j][jnp.clip(starts, 0, nbits - 1)], starts
            )
        err_any = jnp.any(mcu_err0[jnp.clip(starts, 0, nbits - 1)])
        end_pos = mcu_pos0[jnp.clip(starts[-1], 0, nbits - 1)]

        # --- replay each MCU's blocks at n_mcu scale -----------------------
        w16c = w16  # alias
        cur = starts
        ac_offs, diffs, comps_of = [], [], []
        for bi, (dc_slot, ac_slot) in enumerate(seq):
            cc = jnp.clip(cur, 0, nbits - 1)
            dpacked = dc_luts[dc_slot, w16c[cc]]
            dsym = (dpacked << 16) >> 16
            dsize = jnp.clip(dsym, 0, 16)
            dln = dpacked >> 16
            ampw = w16c[jnp.clip(cur + dln, 0, nbits - 1)]
            amp = (ampw >> jnp.clip(16 - dsize, 0, 16)).astype(jnp.int32)
            diffs.append(_extend(amp, dsize))
            ac_offs.append((cur + dln + dsize).astype(jnp.int32))
            ci = class_of[(dc_slot, ac_slot)]
            cur = fb_pos[ci][cc]
        ac_off = jnp.stack(ac_offs, axis=1)   # (n_mcu, bpm)
        diff = jnp.stack(diffs, axis=1)
        return ac_off, diff, end_pos, err_any

    return jax.jit(program)


def decode_scan_prefix(
    scan: bytes,
    mcu_count: int,
    mcu_layout: list,
    htables: dict,
):
    """Restart-free fully-on-device decode: parallel-prefix index + parallel
    AC kernel. Same output contract as decode_scan_indexed (device arrays,
    component-major)."""
    unstuffed = decode_np.unstuff(scan).astype(np.uint8)
    true_bits = len(unstuffed) * 8
    nbytes = 1 << max(8, int(len(unstuffed) + _GUARD).bit_length())
    buf = np.zeros(nbytes, dtype=np.uint8)
    buf[: len(unstuffed)] = unstuffed

    seq = []
    for (_comp, bpm, dc, ac) in mcu_layout:
        seq.extend([(dc, ac)] * bpm)
    seq = tuple(seq)
    dc_slots = tuple(sorted({(0, dc) for (dc, _ac) in seq}))
    ac_slots = tuple(sorted({(1, ac) for (_dc, ac) in seq}))
    dc_of = {k[1]: i for i, k in enumerate(dc_slots)}
    ac_of = {k[1]: i for i, k in enumerate(ac_slots)}
    seq_idx = tuple((dc_of[dc], ac_of[ac]) for (dc, ac) in seq)

    lut_key = tuple(
        (key, htables[key].size.tobytes(), htables[key].code.tobytes())
        for key in ac_slots
    )
    ac_luts = _cached_ac_luts(lut_key, htables, ac_slots)
    canon = _cached_canonical(lut_key, htables, ac_slots)
    dc_luts = jnp.asarray(_packed_dc_luts(htables, dc_slots))

    fn = _jit_prefix_index(nbytes * 8, seq_idx, mcu_count)
    ac_off, diff, end_pos, err = fn(jnp.asarray(buf), dc_luts, ac_luts)
    if bool(np.asarray(err)):
        raise ScanDecodeError("invalid Huffman code (device prefix index)")
    if int(np.asarray(end_pos)) > true_bits:
        raise ScanDecodeError("bit cursor ran past segment end")

    # Component-major ordering (the _decode_ac_indexed contract): all blocks
    # of component 0 in scan order, then component 1, ...
    off_parts, dc_parts, slot_parts = [], [], []
    base = 0
    for (_comp, bpm, _dc, ac) in mcu_layout:
        sl = seq[base:base + bpm]
        off_parts.append(ac_off[:, base:base + bpm].reshape(-1))
        d = diff[:, base:base + bpm].reshape(-1)
        dc_parts.append(jnp.cumsum(d).astype(jnp.int32))
        slot_parts.append(
            jnp.full((mcu_count * bpm,), ac_of[ac], dtype=jnp.int32))
        base += bpm
    off = jnp.concatenate(off_parts)
    dc = jnp.concatenate(dc_parts)
    slot = jnp.concatenate(slot_parts)

    words = jnp.asarray(buf.view(">u4").astype(np.uint32))
    rows = _indexed_jit(words, off, dc, slot, *canon)
    out, b0 = [], 0
    for (_comp, bpm, _, _) in mcu_layout:
        out.append(rows[b0: b0 + bpm * mcu_count])
        b0 += bpm * mcu_count
    return out


def decode_scan(
    scan: bytes,
    mcu_count: int,
    mcu_layout: list,
    htables: dict,
    restart_interval: int,
) -> list[np.ndarray]:
    """Device twin of decode_np.decode_scan (same contract, tables not LUTs).

    Restart-free streams route through the parallel-prefix pointer-doubling
    index (decode_scan_prefix) — fully on device, no serial bit chain; multi-
    segment streams use the vmapped per-segment sequential program."""
    segments = decode_np.split_restart_segments(scan)
    r = restart_interval if restart_interval else mcu_count
    expected = (mcu_count + r - 1) // r
    if len(segments) != expected:
        raise ScanDecodeError(
            f"expected {expected} restart segments, found {len(segments)}"
        )
    if expected == 1 and mcu_count > 1:
        return decode_scan_prefix(scan, mcu_count, mcu_layout, htables)

    slots = sorted({(0, dc) for (_, _, dc, _) in mcu_layout}
                   | {(1, ac) for (_, _, _, ac) in mcu_layout})
    slot_of = {k: i for i, k in enumerate(slots)}
    sym_luts, len_luts = _device_luts(htables, slots)
    layout_key = tuple(
        (comp, bpm, slot_of[(0, dc)], slot_of[(1, ac)])
        for (comp, bpm, dc, ac) in mcu_layout
    )

    unstuffed = [decode_np.unstuff(seg) for seg in segments]
    seg_bits = np.array([len(u) * 8 for u in unstuffed], dtype=np.int64)
    # Bucket the padded length to a power of two so near-identical streams
    # (e.g. the same image re-encoded) reuse the compiled program.
    nbytes = 1 << max(8, int(max(len(u) for u in unstuffed) + _GUARD).bit_length())
    data = np.zeros((len(unstuffed), nbytes), dtype=np.int32)
    for i, u in enumerate(unstuffed):
        data[i, : len(u)] = u
    n_valid = np.minimum(
        r, mcu_count - r * np.arange(len(unstuffed), dtype=np.int64)
    ).astype(np.int32)

    fn = _jit_segments(layout_key, r, nbytes)
    rows, end_pos, err = fn(
        jnp.asarray(data), jnp.asarray(n_valid),
        jnp.asarray(sym_luts), jnp.asarray(len_luts),
    )
    rows = np.asarray(rows)
    end_pos, err = np.asarray(end_pos), np.asarray(err)
    if err.any():
        raise ScanDecodeError(
            f"invalid Huffman code in segment(s) {np.nonzero(err)[0].tolist()}"
        )
    if (end_pos.astype(np.int64) > seg_bits).any():
        raise ScanDecodeError("bit cursor ran past segment end")

    # (S, r, bpm_total, 64) -> (mcu_count, bpm_total, 64) -> per-component.
    full = np.concatenate(
        [rows[s, : n_valid[s]] for s in range(len(unstuffed))], axis=0
    )
    out, off = [], 0
    for (_comp, bpm, _, _) in mcu_layout:
        out.append(full[:, off : off + bpm, :].reshape(mcu_count * bpm, 64))
        off += bpm
    return out
