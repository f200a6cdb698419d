"""Host-side baseline Huffman scan decoder (NumPy + table-driven bit loop).

The decoder side the reference never started (`src/headers/jpg_decode.h` is an
empty shell — SURVEY.md component 16). Huffman decode is inherently serial
within a restart segment (codes are self-delimiting, not self-synchronizing),
so this reference implementation walks bits with a 16-bit-window lookup table;
segments between RSTn markers are independent and are decoded separately (the
C++ runtime decodes them on worker threads, the device path in parallel).
"""

from __future__ import annotations

import numpy as np

from jpeg_tpu.entropy.huffman import HuffTable


class ScanDecodeError(ValueError):
    pass


def make_decode_lut(t: HuffTable) -> tuple[np.ndarray, np.ndarray]:
    """(65536,) symbol and length arrays indexed by a left-aligned 16-bit peek."""
    sym = np.full(1 << 16, -1, dtype=np.int16)
    ln = np.zeros(1 << 16, dtype=np.int8)
    huffsize = np.repeat(np.arange(1, 17, dtype=np.int32), t.bits)
    code = 0
    prev = huffsize[0] if len(huffsize) else 0
    for k, v in enumerate(t.vals):
        size = int(huffsize[k])
        code <<= size - prev
        prev = size
        lo = code << (16 - size)
        hi = lo + (1 << (16 - size))
        sym[lo:hi] = v
        ln[lo:hi] = size
        code += 1
    return sym, ln


def _extend(amp: int, size: int) -> int:
    """Sign-extend a JPEG amplitude field (spec F.2.2.1 EXTEND)."""
    if size == 0:
        return 0
    if amp < (1 << (size - 1)):
        return amp - (1 << size) + 1
    return amp


def split_restart_segments(scan: bytes) -> list[bytes]:
    """Split entropy-coded data on RSTn markers (keeping stuffing intact)."""
    buf = np.frombuffer(scan, dtype=np.uint8)
    if len(buf) < 2:
        return [scan]
    ff = np.nonzero(buf[:-1] == 0xFF)[0]
    nxt = buf[ff + 1]
    rst = ff[(nxt >= 0xD0) & (nxt <= 0xD7)]
    if len(rst) == 0:
        return [scan]
    parts = []
    prev = 0
    for p in rst:
        parts.append(scan[prev:p])
        prev = p + 2
    parts.append(scan[prev:])
    return parts


def unstuff(segment: bytes) -> np.ndarray:
    """Remove 0x00 stuffing bytes after 0xFF."""
    buf = np.frombuffer(segment, dtype=np.uint8)
    if len(buf) < 2:
        return buf.copy()
    drop = np.zeros(len(buf), dtype=bool)
    drop[1:] = (buf[:-1] == 0xFF) & (buf[1:] == 0x00)
    return buf[~drop]


def decode_scan(
    scan: bytes,
    mcu_count: int,
    mcu_layout: list,
    luts: dict,
    restart_interval: int,
) -> list[np.ndarray]:
    """Decode an interleaved scan into per-component zig-zag blocks.

    mcu_layout: list of (comp_index, blocks_per_mcu, dc_id, ac_id) in component
        order within each MCU.
    luts: (is_ac, id) -> (sym_lut, len_lut).
    Returns [ (Nc, 64) int32 ] per component, DC already un-predicted, in the
    order the component's blocks appear in the scan.
    """
    ncomp = len(mcu_layout)
    out = [
        np.zeros((mcu_count * bpm, 64), dtype=np.int32)
        for (_, bpm, _, _) in mcu_layout
    ]

    segments = split_restart_segments(scan)
    r = restart_interval if restart_interval else mcu_count
    expected_segments = (mcu_count + r - 1) // r
    if len(segments) != expected_segments:
        raise ScanDecodeError(
            f"expected {expected_segments} restart segments, found {len(segments)}"
        )

    for s, seg in enumerate(segments):
        first_mcu = s * r
        n_mcu = min(r, mcu_count - first_mcu)
        _decode_segment(seg, first_mcu, n_mcu, mcu_layout, luts, out)
    return out


def _decode_segment(segment, first_mcu, n_mcu, mcu_layout, luts, out):
    b = unstuff(segment)
    max_bits = len(b) * 8
    # Guard region sized for one worst-case MCU (10 blocks x 64 symbols x
    # 26 bits < 2.1 KB), so a corrupt stream that free-runs on zero windows
    # is caught by the per-MCU cursor check below instead of IndexError.
    b = np.concatenate([b, np.zeros(4096, dtype=np.uint8)])
    data = b.tolist()  # python ints: fastest random access in the bit loop
    pos = 0  # bit cursor
    preds = [0] * len(mcu_layout)

    for m in range(n_mcu):
        if pos > max_bits:
            raise ScanDecodeError("bit cursor ran past segment end")
        for ci, (comp, bpm, dc_id, ac_id) in enumerate(mcu_layout):
            dc_sym, dc_len = luts[(0, dc_id)]
            ac_sym, ac_len = luts[(1, ac_id)]
            for blk in range(bpm):
                row = out[ci][(first_mcu + m) * bpm + blk]
                # --- DC ---
                i, sh = pos >> 3, pos & 7
                w = ((data[i] << 16 | data[i + 1] << 8 | data[i + 2]) >> (8 - sh)) & 0xFFFF
                size = int(dc_sym[w])
                if size < 0:
                    raise ScanDecodeError(f"bad DC code at bit {pos}")
                pos += int(dc_len[w])
                if size:
                    i, sh = pos >> 3, pos & 7
                    amp = ((data[i] << 16 | data[i + 1] << 8 | data[i + 2]) >> (8 - sh)) & 0xFFFF
                    amp >>= 16 - size
                    pos += size
                    diff = _extend(amp, size)
                else:
                    diff = 0
                preds[ci] += diff
                row[0] = preds[ci]
                # --- AC ---
                k = 1
                while k < 64:
                    i, sh = pos >> 3, pos & 7
                    w = ((data[i] << 16 | data[i + 1] << 8 | data[i + 2]) >> (8 - sh)) & 0xFFFF
                    sym = int(ac_sym[w])
                    if sym < 0:
                        raise ScanDecodeError(f"bad AC code at bit {pos}")
                    pos += int(ac_len[w])
                    if sym == 0:  # EOB
                        break
                    if sym == 0xF0:  # ZRL
                        k += 16
                        continue
                    k += sym >> 4
                    size = sym & 15
                    if k > 63:
                        raise ScanDecodeError("AC run past end of block")
                    i, sh = pos >> 3, pos & 7
                    amp = ((data[i] << 16 | data[i + 1] << 8 | data[i + 2]) >> (8 - sh)) & 0xFFFF
                    amp >>= 16 - size
                    pos += size
                    row[k] = _extend(amp, size)
                    k += 1
    if pos > max_bits:
        raise ScanDecodeError("bit cursor ran past segment end")
