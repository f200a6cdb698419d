"""Progressive (SOF2) JPEG *encoding*: spectral selection + successive
approximation, the writer side of entropy/progressive_np.py's reader.

The one capability class libjpeg has that the engine could otherwise read
but not emit. The default scan script is libjpeg's
standard 10-scan YCbCr script (jcparam.c); every scan's Huffman table is
built from that scan's own symbol statistics (progressive AC scans need
EOBn symbols the baseline K.3 tables don't define, so per-scan optimal
tables are not an option but a requirement — same reason libjpeg always
optimizes progressive entropy).

Scan coding follows ITU-T T.81 Annex G exactly as our reader implements it
(the writer was built to mirror progressive_np's per-scan semantics
statement for statement):
  * DC first:    DPCM of (DC >> Al) (arithmetic shift), interleaved.
  * DC refine:   one raw bit per block — (DC >> Al) & 1.
  * AC first:    band runs + EOBRUN accumulation across blocks.
  * AC refine:   newly-significant (|v| >> Al == 1) coefficients as
                 (run, 1) + sign, correction bits for already-significant
                 ones buffered and flushed after each symbol (ZRL, (r,1)
                 or EOBn) — the G.1.2.3 bit-buffer discipline.

The quantized coefficients are byte-for-byte the ones baseline encode()
emits (same transform path), so progressive and sequential streams decode
to identical pixels; tests pin our decoder and PIL pixel-identical on the
output.

Scope note: the transform runs on the device (the same jitted pipeline as
baseline encode), but scan emission is host Python — progressive encoding
is a capability/compatibility surface here, not a throughput path (the
bench paths are baseline sequential; libjpeg's own progressive encoder is
also its slow path). A C++ scan emitter in native/entropy.cc is the
obvious extension if progressive output ever becomes hot.
"""

from __future__ import annotations

import struct

import jax.numpy as jnp
import numpy as np

from jpeg_tpu import tables as T
from jpeg_tpu.config import EncodeConfig, Subsampling
from jpeg_tpu.entropy import encode_np, huffman
from jpeg_tpu.io import bmp, jfif
from jpeg_tpu.models import encoder as E
from jpeg_tpu.ops import quant, tile

# libjpeg's standard progressive scan script (jcparam.c fill_scans), color:
# (component indices, Ss, Se, Ah, Al).
SCRIPT_COLOR = (
    ((0, 1, 2), 0, 0, 0, 1),
    ((0,), 1, 5, 0, 2),
    ((2,), 1, 63, 0, 1),
    ((1,), 1, 63, 0, 1),
    ((0,), 6, 63, 0, 2),
    ((0,), 1, 63, 2, 1),
    ((0, 1, 2), 0, 0, 1, 0),
    ((2,), 1, 63, 1, 0),
    ((1,), 1, 63, 1, 0),
    ((0,), 1, 63, 1, 0),
)
SCRIPT_GRAY = (
    ((0,), 0, 0, 0, 1),
    ((0,), 1, 5, 0, 2),
    ((0,), 6, 63, 0, 2),
    ((0,), 1, 63, 2, 1),
    ((0,), 0, 0, 1, 0),
    ((0,), 1, 63, 1, 0),
)


class _Recorder:
    """Two-phase scan emitter: collect (class, tid, symbol) records plus raw
    bit runs in emission order; count symbol stats; then render to a
    (codes, nbits) stream once the scan's Huffman tables exist."""

    def __init__(self):
        self.items = []  # ("sym", tid, symbol) | ("bits", value, nbits)

    def sym(self, tid: int, symbol: int):
        self.items.append(("sym", tid, symbol))

    def bits(self, value: int, nbits: int):
        if nbits:
            self.items.append(("bits", value, nbits))

    def counts(self):
        freq = {}
        for kind, a, b in self.items:
            if kind == "sym":
                h = freq.setdefault(a, np.zeros(256, np.int64))
                h[b] += 1
        return freq

    def render(self, huff_by_tid: dict) -> bytes:
        codes = np.empty(len(self.items), np.int64)
        nbits = np.empty(len(self.items), np.int64)
        for i, (kind, a, b) in enumerate(self.items):
            if kind == "sym":
                t = huff_by_tid[a]
                codes[i] = t.code[b]
                nbits[i] = t.size[b]
            else:
                codes[i] = a
                nbits[i] = b
        keep = nbits > 0
        return encode_np._stuff_bytes(
            encode_np._pack_bits(codes[keep], nbits[keep])).tobytes()


def _point_ac(v: np.ndarray, al: int) -> np.ndarray:
    """AC successive-approximation point transform: magnitude shift toward
    zero (G.1.2.2)."""
    return np.where(v >= 0, v >> al, -((-v) >> al))


def _emit_dc_first(rec: _Recorder, blocks_iter, tids, al):
    preds = {}
    for ci, coef in blocks_iter:
        v = int(coef[0]) >> al  # arithmetic shift (G.1.2.1)
        diff = v - preds.get(ci, 0)
        preds[ci] = v
        mag = abs(diff)
        size = int(mag).bit_length()
        rec.sym(tids[ci], size)
        if size:
            rec.bits(diff if diff >= 0 else diff + (1 << size) - 1, size)


def _emit_dc_refine(rec: _Recorder, blocks_iter, al):
    for _ci, coef in blocks_iter:
        rec.bits((int(coef[0]) >> al) & 1, 1)


def _flush_eobrun(rec: _Recorder, tid: int, eobrun: int, buffered):
    if eobrun > 0:
        r = eobrun.bit_length() - 1
        rec.sym(tid, r << 4)
        if r:
            rec.bits(eobrun - (1 << r), r)
    for b in buffered:
        rec.bits(b, 1)
    buffered.clear()
    return 0


def _emit_ac_first(rec: _Recorder, blocks, tid, ss, se, al):
    eobrun = 0
    for coef in blocks:
        band = _point_ac(coef[ss:se + 1].astype(np.int64), al)
        nz = np.nonzero(band)[0]
        if nz.size == 0:
            eobrun += 1
            if eobrun == 0x7FFF:
                eobrun = _flush_eobrun(rec, tid, eobrun, [])
            continue
        eobrun = _flush_eobrun(rec, tid, eobrun, [])
        run = 0
        prev = -1
        for k in nz:
            run = int(k) - prev - 1
            prev = int(k)
            while run > 15:
                rec.sym(tid, 0xF0)
                run -= 16
            v = int(band[k])
            mag = abs(v)
            size = mag.bit_length()
            rec.sym(tid, (run << 4) | size)
            rec.bits(v if v >= 0 else v + (1 << size) - 1, size)
        if int(nz[-1]) != se - ss:
            eobrun += 1
            if eobrun == 0x7FFF:
                eobrun = _flush_eobrun(rec, tid, eobrun, [])
    _flush_eobrun(rec, tid, eobrun, [])


def _emit_ac_refine(rec: _Recorder, blocks, tid, ss, se, al):
    eobrun = 0
    buffered: list[int] = []
    for coef in blocks:
        band = coef[ss:se + 1].astype(np.int64)
        absval = np.abs(band) >> al
        newly = np.nonzero(absval == 1)[0]
        if newly.size == 0:
            # Whole block joins the EOB run; its history coefficients'
            # correction bits ride the buffer until the EOBn flush.
            for k in range(se - ss + 1):
                if absval[k] > 1:
                    buffered.append(int(absval[k]) & 1)
            eobrun += 1
            if eobrun == 0x7FFF:
                eobrun = _flush_eobrun(rec, tid, eobrun, buffered)
            continue
        eobrun = _flush_eobrun(rec, tid, eobrun, buffered)
        k = 0
        last_new = int(newly[-1])
        run = 0
        while k <= last_new:
            a = int(absval[k])
            if a == 0:
                run += 1
                k += 1
                continue
            # ZRL check at EVERY nonzero (history or new) with the
            # per-ZRL buffered-bits flush — the decoder's ZRL advance
            # consumes the correction bits of history coefficients it
            # passes, so each ZRL must carry exactly the bits buffered
            # before its emission point (G.1.2.3; jcphuff.c discipline —
            # flushing only at new-significant coefficients desynchronizes
            # the bit order when a history coefficient interrupts a run).
            while run > 15:
                rec.sym(tid, 0xF0)
                for b in buffered:
                    rec.bits(b, 1)
                buffered.clear()
                run -= 16
            if a > 1:
                buffered.append(a & 1)
                k += 1
                continue
            # newly significant at k
            rec.sym(tid, (run << 4) | 1)
            rec.bits(1 if band[k] > 0 else 0, 1)
            for b in buffered:
                rec.bits(b, 1)
            buffered.clear()
            run = 0
            k += 1
        if last_new != se - ss:
            # Tail after the last new-significant coefficient: correction
            # bits buffer, the block ends in an EOB run.
            for kk in range(last_new + 1, se - ss + 1):
                if absval[kk] > 1:
                    buffered.append(int(absval[kk]) & 1)
            eobrun += 1
            if eobrun == 0x7FFF:
                eobrun = _flush_eobrun(rec, tid, eobrun, buffered)
    _flush_eobrun(rec, tid, eobrun, buffered)


def _mcu_iter(comp_blocks, comp_order, grids, hvs):
    """Interleaved MCU block order over the scan's components (A.2.3):
    per MCU, each component contributes its v*h raster sub-blocks."""
    if len(comp_order) == 1:
        ci = comp_order[0]
        for coef in comp_blocks[ci]:
            yield ci, coef
        return
    mcu_rows, mcu_cols = grids
    for my in range(mcu_rows):
        for mx in range(mcu_cols):
            for ci in comp_order:
                h, v = hvs[ci]
                wb = mcu_cols * h
                for by in range(v):
                    for bx in range(h):
                        idx = (my * v + by) * wb + (mx * h + bx)
                        yield ci, comp_blocks[ci][idx]


def encode_progressive(
    image,
    quality: int = 75,
    subsampling="420",
    scans=None,
    comment: str | None = None,
) -> bytes:
    """Encode RGB (H, W, 3) or gray (H, W) uint8 to a progressive (SOF2)
    JFIF stream. scans: optional custom script of (comp_indices, Ss, Se,
    Ah, Al) tuples; defaults to libjpeg's standard script. Restart
    intervals are not emitted (DRI-free scans; our reader and libjpeg both
    accept that)."""
    if isinstance(image, str):
        image = bmp.read_bmp(image)
    image = np.asarray(image)
    gray = image.ndim == 2
    cfg = EncodeConfig(quality=quality,
                       subsampling="444" if gray else subsampling)
    mode = cfg.subsampling
    h0, w0 = image.shape[:2]

    qy_np = quant.luma_table(quality)
    qc_np = quant.chroma_table(quality)
    if gray:
        img = tile.pad_to_multiple(jnp.asarray(image), 8, 8)
        y = np.asarray(E._jit_gray()(img, jnp.asarray(qy_np)))
        comp_blocks = [y.astype(np.int64)]
        comps = [jfif.ComponentSpec(1, 1, 1, 0, 0, 0)]
        hvs = [(1, 1)]
        tids = [0]
        grids = (img.shape[0] // 8, img.shape[1] // 8)
        script = SCRIPT_GRAY if scans is None else scans
        qtabs = [(0, qy_np)]
        # One component: the 8-aligned grid IS the spec block raster.
        spec_blocks = comp_blocks
    else:
        img = tile.pad_to_multiple(
            jnp.asarray(image), mode.mcu_height, mode.mcu_width)
        y, cb, cr = (
            np.asarray(a).astype(np.int64)
            for a in E._jit_color(mode)(
                img, jnp.asarray(qy_np), jnp.asarray(qc_np))
        )
        comp_blocks = [y, cb, cr]
        comps = E._color_components(mode)
        hvs = [(mode.h_factor, mode.v_factor), (1, 1), (1, 1)]
        tids = [0, 1, 1]
        grids = (img.shape[0] // mode.mcu_height,
                 img.shape[1] // mode.mcu_width)
        script = SCRIPT_COLOR if scans is None else scans

        qtabs = [(0, qy_np), (1, qc_np)]
        # Non-interleaved (single-component) scans code ONLY the
        # component's own ceil(size/8) block raster (spec A.2.2) — the
        # MCU-padding block columns/rows that interleaved scans carry are
        # NOT coded. Crop each component's padded (gh, gw) grid to its
        # spec (bh, bw); emitting the padded grid desyncs every decoder
        # (ours and libjpeg) at the first width-padded row.
        hmax, vmax = mode.h_factor, mode.v_factor
        spec_blocks = []
        for ci, ((h_f, v_f), blocks) in enumerate(zip(hvs, comp_blocks)):
            gh, gw = grids[0] * v_f, grids[1] * h_f
            cw = -(-w0 * h_f // hmax)
            ch = -(-h0 * v_f // vmax)
            bh, bw = -(-ch // 8), -(-cw // 8)
            spec_blocks.append(
                blocks.reshape(gh, gw, 64)[:bh, :bw].reshape(-1, 64))

    # --- record every scan, with per-scan optimal tables ---------------
    rendered = []  # (sos_payload, dht_segments, scan_bytes)
    for comp_idx, ss, se, ah, al in script:
        rec = _Recorder()
        is_dc = ss == 0
        if is_dc and se != 0:
            raise ValueError("DC scans must have Ss=Se=0 (spec G.1.1.1.1)")
        if not is_dc and len(comp_idx) != 1:
            raise ValueError("AC scans must be single-component (G.1.1.1.1)")
        if is_dc:
            # Multi-component DC scans interleave the full MCU grid;
            # single-component scans (DC or AC) are non-interleaved and
            # code the component's spec block raster only.
            src = comp_blocks if len(comp_idx) > 1 else spec_blocks
            it = _mcu_iter(src, comp_idx, grids, hvs)
            if ah == 0:
                _emit_dc_first(rec, it, tids, al)
            else:
                _emit_dc_refine(rec, it, al)
        else:
            ci = comp_idx[0]
            tid = tids[ci]
            if ah == 0:
                _emit_ac_first(rec, spec_blocks[ci], tid, ss, se, al)
            else:
                _emit_ac_refine(rec, spec_blocks[ci], tid, ss, se, al)

        freq = rec.counts()
        tabs = {tid: huffman.optimal_table(h) for tid, h in freq.items()}
        scan_bytes = rec.render(tabs)

        dhts = []
        for tid, t in sorted(tabs.items()):
            cls = 0 if is_dc else 1
            p = bytes([(cls << 4) | tid]) + bytes(int(x) for x in t.bits) \
                + bytes(int(x) for x in t.vals)
            dhts.append(struct.pack(">BBH", 0xFF, jfif.DHT, len(p) + 2) + p)

        sos = bytes([len(comp_idx)])
        for ci in comp_idx:
            c = comps[ci]
            tid = tids[ci]
            # DC first: Td = component's DC table, Ta unused (0). DC
            # refinement reads no entropy table at all (raw bits) and AC
            # scans use no DC table — both write 0 for the unused id,
            # matching libjpeg's convention.
            td = tid if (is_dc and ah == 0) else 0
            ta = 0 if is_dc else tid
            sos += struct.pack(">BB", c.comp_id, (td << 4) | ta)
        sos += bytes([ss, se, (ah << 4) | al])
        rendered.append((sos, dhts, scan_bytes))

    # --- assemble ------------------------------------------------------
    out = [b"\xff\xd8"]
    app0 = b"JFIF\x00" + struct.pack(">BBBHHBB", 1, 1, 1, 72, 72, 0, 0)
    out.append(struct.pack(">BBH", 0xFF, jfif.APP0, len(app0) + 2) + app0)
    if comment:
        cb_ = comment.encode()
        out.append(struct.pack(">BBH", 0xFF, jfif.COM, len(cb_) + 2) + cb_)
    for qid, q in qtabs:
        zz = np.asarray(q, np.int32).reshape(64)[T.ZIGZAG_ORDER]
        out.append(struct.pack(">BBH", 0xFF, jfif.DQT, 67) + bytes([qid])
                   + bytes(int(x) for x in zz))
    sof = struct.pack(">BHHB", 8, h0, w0, len(comps))
    for c, (h, v), tid in zip(comps, hvs, tids):
        sof += struct.pack(">BBB", c.comp_id, (h << 4) | v, c.qtab_id)
    out.append(struct.pack(">BBH", 0xFF, jfif.SOF2, len(sof) + 2) + sof)
    for sos, dhts, scan_bytes in rendered:
        out.extend(dhts)
        out.append(struct.pack(">BBH", 0xFF, jfif.SOS, len(sos) + 2) + sos)
        out.append(scan_bytes)
    out.append(b"\xff\xd9")
    return b"".join(out)
