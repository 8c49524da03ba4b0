"""JPEG writers for the decoder's fixtures and tests, in plain Python: the
files Pillow cannot write.

  * :func:`coefficients` reads a baseline Huffman file's quantised DCT
    coefficients (T.81 Annex F.2.2, no restart intervals);
  * :func:`arithmetic` re-encodes them with the QM coder (T.81 Annex D,
    the bins of Annex F.1.4.4 and G.1.3), sequential (SOF9) or
    progressive (SOF10, libjpeg's ``jpeg_simple_progression`` script),
    with a restart interval and DAC conditioning if asked. The encoder is
    libjpeg's ``jcarith.c``, step for step. Its twin is the Huffman file
    it came from: both decode to the same coefficients, so to the same
    pixels in any decoder;
  * :func:`lossless` writes a lossless (SOF3) file of 8-bit samples with
    any of the seven predictors, a point transform, restarts every few
    rows and any sampling factors, Huffman-coded with the standard DC
    table;
  * :func:`edit_sof` rewrites a frame header's marker, precision,
    sampling or component count, for the files every reference refuses.

Used by ``tools/make_jpeg_fixtures.py`` and ``tests/test_torch_jpeg.py``;
no part of the decoding path imports it.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

# T.81 Table D.3: (Qe, Next_Index_LPS, Next_Index_MPS, Switch_MPS), and
# libjpeg's state 113, the fixed probability 0.5
_QE = [
    (0x5a1d, 1, 1, 1), (0x2586, 14, 2, 0), (0x1114, 16, 3, 0),
    (0x080b, 18, 4, 0), (0x03d8, 20, 5, 0), (0x01da, 23, 6, 0),
    (0x00e5, 25, 7, 0), (0x006f, 28, 8, 0), (0x0036, 30, 9, 0),
    (0x001a, 33, 10, 0), (0x000d, 35, 11, 0), (0x0006, 9, 12, 0),
    (0x0003, 10, 13, 0), (0x0001, 12, 13, 0), (0x5a7f, 15, 15, 1),
    (0x3f25, 36, 16, 0), (0x2cf2, 38, 17, 0), (0x207c, 39, 18, 0),
    (0x17b9, 40, 19, 0), (0x1182, 42, 20, 0), (0x0cef, 43, 21, 0),
    (0x09a1, 45, 22, 0), (0x072f, 46, 23, 0), (0x055c, 48, 24, 0),
    (0x0406, 49, 25, 0), (0x0303, 51, 26, 0), (0x0240, 52, 27, 0),
    (0x01b1, 54, 28, 0), (0x0144, 56, 29, 0), (0x00f5, 57, 30, 0),
    (0x00b7, 59, 31, 0), (0x008a, 60, 32, 0), (0x0068, 62, 33, 0),
    (0x004e, 63, 34, 0), (0x003b, 32, 35, 0), (0x002c, 33, 9, 0),
    (0x5ae1, 37, 37, 1), (0x484c, 64, 38, 0), (0x3a0d, 65, 39, 0),
    (0x2ef1, 67, 40, 0), (0x261f, 68, 41, 0), (0x1f33, 69, 42, 0),
    (0x19a8, 70, 43, 0), (0x1518, 72, 44, 0), (0x1177, 73, 45, 0),
    (0x0e74, 74, 46, 0), (0x0bfb, 75, 47, 0), (0x09f8, 77, 48, 0),
    (0x0861, 78, 49, 0), (0x0706, 79, 50, 0), (0x05cd, 48, 51, 0),
    (0x04de, 50, 52, 0), (0x040f, 50, 53, 0), (0x0363, 51, 54, 0),
    (0x02d4, 52, 55, 0), (0x025c, 53, 56, 0), (0x01f8, 54, 57, 0),
    (0x01a4, 55, 58, 0), (0x0160, 56, 59, 0), (0x0125, 57, 60, 0),
    (0x00f6, 58, 61, 0), (0x00cb, 59, 62, 0), (0x00ab, 61, 63, 0),
    (0x008f, 61, 32, 0), (0x5b12, 65, 65, 1), (0x4d04, 80, 66, 0),
    (0x412c, 81, 67, 0), (0x37d8, 82, 68, 0), (0x2fe8, 83, 69, 0),
    (0x293c, 84, 70, 0), (0x2379, 86, 71, 0), (0x1edf, 87, 72, 0),
    (0x1aa9, 87, 73, 0), (0x174e, 72, 74, 0), (0x1424, 72, 75, 0),
    (0x119c, 74, 76, 0), (0x0f6b, 74, 77, 0), (0x0d51, 75, 78, 0),
    (0x0bb6, 77, 79, 0), (0x0a40, 77, 48, 0), (0x5832, 80, 81, 1),
    (0x4d1c, 88, 82, 0), (0x438e, 89, 83, 0), (0x3bdd, 90, 84, 0),
    (0x34ee, 91, 85, 0), (0x2eae, 92, 86, 0), (0x299a, 93, 87, 0),
    (0x2516, 86, 71, 0), (0x5570, 88, 89, 1), (0x4ca9, 95, 90, 0),
    (0x44d9, 96, 91, 0), (0x3e22, 97, 92, 0), (0x3824, 99, 93, 0),
    (0x32b4, 99, 94, 0), (0x2e17, 93, 86, 0), (0x56a8, 95, 96, 1),
    (0x4f46, 101, 97, 0), (0x47e5, 102, 98, 0), (0x41cf, 103, 99, 0),
    (0x3c3d, 104, 100, 0), (0x375e, 99, 93, 0), (0x5231, 105, 102, 0),
    (0x4c0f, 106, 103, 0), (0x4639, 107, 104, 0), (0x415e, 103, 99, 0),
    (0x5627, 105, 106, 1), (0x50e7, 108, 107, 0), (0x4b85, 109, 103, 0),
    (0x5597, 110, 109, 0), (0x504f, 111, 107, 0), (0x5a10, 110, 111, 1),
    (0x5522, 112, 109, 0), (0x59eb, 112, 111, 1), (0x5a1d, 113, 113, 0)]

# T.81 Annex K.3: the luminance DC table (categories 0-11)
STD_DC_BITS = (0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0)
STD_DC_VALS = tuple(range(12))

# libjpeg's jpeg_simple_progression: (components, Ss, Se, Ah, Al)
PROGRESSION_YCC = ((None, 0, 0, 0, 1), ((0,), 1, 5, 0, 2), ((2,), 1, 63, 0, 1),
                   ((1,), 1, 63, 0, 1), ((0,), 6, 63, 0, 2),
                   ((0,), 1, 63, 2, 1), (None, 0, 0, 1, 0),
                   ((2,), 1, 63, 1, 0), ((1,), 1, 63, 1, 0),
                   ((0,), 1, 63, 1, 0))
PROGRESSION_GRAY = ((None, 0, 0, 0, 1), ((0,), 1, 5, 0, 2),
                    ((0,), 6, 63, 0, 2), ((0,), 1, 63, 2, 1),
                    (None, 0, 0, 1, 0), ((0,), 1, 63, 1, 0))


def segments(data: bytes) -> List[Tuple[int, bytes, bytes]]:
    """[(marker, segment body, entropy-coded data after it)] from SOI to
    EOI; the data is empty but after an SOS."""
    if data[:2] != b"\xff\xd8":
        raise ValueError("not a JPEG file")
    out, pos = [], 2
    while pos < len(data):
        while data[pos] == 0xFF:
            pos += 1
        m = data[pos]
        pos += 1
        if m == 0xD9:
            break
        n = int.from_bytes(data[pos:pos + 2], "big")
        body, pos = data[pos + 2:pos + n], pos + n
        scan = b""
        if m == 0xDA:
            end = pos
            while True:
                end = data.index(b"\xff", end)
                if data[end + 1] != 0 and not 0xD0 <= data[end + 1] <= 0xD7:
                    break
                end += 2
            scan, pos = data[pos:end], end
        out.append((m, body, scan))
    return out


def _segment(marker: int, body: bytes) -> bytes:
    return bytes((0xFF, marker)) + (len(body) + 2).to_bytes(2, "big") + body


class Frame:
    """A frame header's geometry: per component (id, h, v, tq), the MCU
    grid, each component's block counts."""

    def __init__(self, sof: bytes):
        self.height = int.from_bytes(sof[1:3], "big")
        self.width = int.from_bytes(sof[3:5], "big")
        n = sof[5]
        self.comps = [(sof[6 + 3 * i], sof[7 + 3 * i] >> 4,
                       sof[7 + 3 * i] & 15, sof[8 + 3 * i]) for i in range(n)]
        self.hmax = max(c[1] for c in self.comps)
        self.vmax = max(c[2] for c in self.comps)
        self.mcus_x = -(-self.width // (8 * self.hmax))
        self.mcus_y = -(-self.height // (8 * self.vmax))
        self.blocks = [(-(-self.width * h // (8 * self.hmax)),
                        -(-self.height * v // (8 * self.vmax)))
                       for _, h, v, _ in self.comps]


def _huffman_table(body: bytes, pos: int):
    index = body[pos]
    counts = body[pos + 1:pos + 17]
    vals = body[pos + 17:pos + 17 + sum(counts)]
    table, code, k = {}, 0, 0
    for length in range(1, 17):
        for _ in range(counts[length - 1]):
            table[(length, code)] = vals[k]
            code, k = code + 1, k + 1
        code <<= 1
    return index, table, pos + 17 + sum(counts)


def _unstuff(scan: bytes) -> np.ndarray:
    return np.unpackbits(np.frombuffer(scan.replace(b"\xff\x00", b"\xff"),
                                       np.uint8))


def coefficients(data: bytes) -> Tuple[Frame, Dict, List[np.ndarray]]:
    """(frame, {marker: [bodies]} of the header segments, per component
    its (rows, cols, 64) int32 coefficients in zigzag order, rows and
    cols whole MCUs) of a baseline single-scan Huffman file."""
    segs = segments(data)
    headers: Dict[int, List[bytes]] = {}
    tables = {}
    frame, scan = None, None
    for m, body, entropy in segs:
        headers.setdefault(m, []).append(body)
        if m in (0xC1, 0xC2) or 0xC3 <= m <= 0xCF and m not in (0xC4, 0xCC):
            raise ValueError(f"not a baseline file (SOF {m:#x})")
        if m == 0xC0:
            frame = Frame(body)
        elif m == 0xC4:
            pos = 0
            while pos < len(body):
                index, table, pos = _huffman_table(body, pos)
                tables[index] = table
        elif m == 0xDD and int.from_bytes(body, "big"):
            raise ValueError("restart intervals are not read")
        elif m == 0xDA:
            if scan is not None:
                raise ValueError("more than one scan")
            scan = (body, entropy)
    body, entropy = scan
    sel = {body[1 + 2 * i]: body[2 + 2 * i] for i in range(body[0])}
    bits = _unstuff(entropy)
    pos = 0

    def receive(n):
        nonlocal pos
        v = 0
        for _ in range(n):
            v = (v << 1) | int(bits[pos]) if pos < len(bits) else v << 1
            pos += 1
        return v

    def decode(table):
        nonlocal pos
        code = 0
        for length in range(1, 17):
            code = (code << 1) | (int(bits[pos]) if pos < len(bits) else 0)
            pos += 1
            if (length, code) in table:
                return table[(length, code)]
        raise ValueError("bad Huffman code")

    def extend(v, s):
        return v - (1 << s) + 1 if s and v < 1 << (s - 1) else v

    coefs = [np.zeros((frame.mcus_y * v, frame.mcus_x * h, 64), np.int32)
             for _, h, v, _ in frame.comps]
    pred = [0] * len(frame.comps)

    def block(ci):
        t = sel[frame.comps[ci][0]]
        dc, ac = tables[t >> 4], tables[0x10 | (t & 15)]
        out = np.zeros(64, np.int32)
        s = decode(dc)
        pred[ci] += extend(receive(s), s)
        out[0] = pred[ci]
        k = 1
        while k < 64:
            rs = decode(ac)
            r, s = rs >> 4, rs & 15
            if s:
                k += r
                out[k] = extend(receive(s), s)
                k += 1
            elif r == 15:
                k += 16
            else:
                break
        return out

    if len(frame.comps) == 1:
        bw, bh = frame.blocks[0]
        for y in range(bh):
            for x in range(bw):
                coefs[0][y, x] = block(0)
    else:
        for my in range(frame.mcus_y):
            for mx in range(frame.mcus_x):
                for ci, (_, h, v, _) in enumerate(frame.comps):
                    for y in range(v):
                        for x in range(h):
                            coefs[ci][my * v + y, mx * h + x] = block(ci)
    return frame, headers, coefs


class QMEncoder:
    """libjpeg's jcarith.c arithmetic encoder, its statistics bins kept
    by the caller (``bytearray``s)."""

    def __init__(self):
        self.out = bytearray()
        self.reset()

    def reset(self):
        self.c, self.a, self.sc, self.zc, self.ct = 0, 0x10000, 0, 0, 11
        self.buffer = -1

    def _emit(self, b):
        self.out.append(b)

    def _flush_zeros(self):
        while self.zc:
            self._emit(0)
            self.zc -= 1

    def encode(self, st: bytearray, i: int, val: int):
        sv = st[i]
        qe, nlps, nmps, switch = _QE[sv & 0x7F]
        nl = nlps | (switch << 7)
        self.a -= qe
        if val != sv >> 7:
            if self.a >= qe:
                self.c += self.a
                self.a = qe
            st[i] = (sv & 0x80) ^ nl
        else:
            if self.a >= 0x8000:
                return
            if self.a < qe:
                self.c += self.a
                self.a = qe
            st[i] = (sv & 0x80) ^ nmps
        while True:
            self.a <<= 1
            self.c <<= 1
            self.ct -= 1
            if self.ct == 0:
                temp = self.c >> 19
                if temp > 0xFF:
                    if self.buffer >= 0:
                        self._flush_zeros()
                        self._emit(self.buffer + 1)
                        if self.buffer + 1 == 0xFF:
                            self._emit(0)
                    self.zc += self.sc
                    self.sc = 0
                    self.buffer = temp & 0xFF
                elif temp == 0xFF:
                    self.sc += 1
                else:
                    self._out_stacked()
                    self.buffer = temp & 0xFF
                self.c &= 0x7FFFF
                self.ct += 8
            if self.a >= 0x8000:
                break

    def _out_stacked(self):
        if self.buffer == 0:
            self.zc += 1
        elif self.buffer >= 0:
            self._flush_zeros()
            self._emit(self.buffer)
        if self.sc:
            self._flush_zeros()
            for _ in range(self.sc):
                self._emit(0xFF)
                self._emit(0)
            self.sc = 0

    def finish(self):
        """jcarith.c finish_pass: the shortest code in the interval."""
        temp = (self.a - 1 + self.c) & 0xFFFF0000
        self.c = temp + 0x8000 if temp < self.c else temp
        self.c <<= self.ct
        if self.c & 0xF8000000:
            if self.buffer >= 0:
                self._flush_zeros()
                self._emit(self.buffer + 1)
                if self.buffer + 1 == 0xFF:
                    self._emit(0)
            self.zc += self.sc
            self.sc = 0
        else:
            self._out_stacked()
        if self.c & 0x7FFF800:
            self._flush_zeros()
            self._emit((self.c >> 19) & 0xFF)
            if (self.c >> 19) & 0xFF == 0xFF:
                self._emit(0)
            if self.c & 0x7F800:
                self._emit((self.c >> 11) & 0xFF)
                if (self.c >> 11) & 0xFF == 0xFF:
                    self._emit(0)


class _ArithScan:
    """One scan's statistics and predictions (jcarith.c's encode_mcu*)."""

    def __init__(self, enc: QMEncoder, ncomp: int, dc_tbl, ac_tbl, L, U, K):
        self.e = enc
        self.dc_tbl, self.ac_tbl = dc_tbl, ac_tbl
        self.L, self.U, self.K = L, U, K
        self.dc_stats = {t: bytearray(64) for t in set(dc_tbl)}
        self.ac_stats = {t: bytearray(256) for t in set(ac_tbl)}
        self.fixed = bytearray([113])
        self.ncomp = ncomp
        self.restart()

    def restart(self):
        for s in (*self.dc_stats.values(), *self.ac_stats.values()):
            s[:] = bytes(len(s))
        self.last_dc = [0] * self.ncomp
        self.ctx = [0] * self.ncomp

    def _magnitude(self, st, i, v, k_table=None):
        """Figures F.8-F.9 from bin ``i`` (SP/SN, or the AC S0 + 2) for
        v - 1 = ``v``; ``k_table`` gives the AC X1 bin."""
        e = self.e
        m = 0
        if v:
            e.encode(st, i, 1)
            m = 1
            v2 = v
            if k_table is None:
                i = 20
                v2 >>= 1
                while v2:
                    e.encode(st, i, 1)
                    m <<= 1
                    i += 1
                    v2 >>= 1
            else:
                v2 >>= 1
                if v2:
                    e.encode(st, i, 1)
                    m <<= 1
                    i = k_table
                    v2 >>= 1
                    while v2:
                        e.encode(st, i, 1)
                        m <<= 1
                        i += 1
                        v2 >>= 1
        e.encode(st, i, 0)
        i += 14
        m >>= 1
        while m:
            e.encode(st, i, 1 if m & v else 0)
            m >>= 1
        return m

    def dc(self, ci: int, value: int):
        t = self.dc_tbl[ci]
        st = self.dc_stats[t]
        i = self.ctx[ci]
        v = value - self.last_dc[ci]
        if v == 0:
            self.e.encode(st, i, 0)
            self.ctx[ci] = 0
            return
        self.last_dc[ci] = value
        self.e.encode(st, i, 1)
        if v > 0:
            self.e.encode(st, i + 1, 0)
            i += 2
            self.ctx[ci] = 4
        else:
            v = -v
            self.e.encode(st, i + 1, 1)
            i += 3
            self.ctx[ci] = 8
        v -= 1
        m = 0
        if v:
            m = 1 << (v.bit_length() - 1) if v > 1 else 1
        # the conditioning category from the magnitude category
        if m < (1 << self.L[t]) >> 1:
            ctx = 0
        elif m > (1 << self.U[t]) >> 1:
            ctx = self.ctx[ci] + 8
        else:
            ctx = self.ctx[ci]
        self._magnitude(st, i, v)
        self.ctx[ci] = ctx

    def ac(self, ci: int, zz: Sequence[int], ss: int, se: int, al: int):
        """AC coefficients ss..se of one block (zigzag ``zz``), point
        transformed by ``al`` (Figure F.5, G.1.3.2)."""
        t = self.ac_tbl[ci]
        st = self.ac_stats[t]
        e = self.e
        vals = [(abs(int(zz[k])) >> al) * (1 if zz[k] >= 0 else -1)
                for k in range(64)]
        ke = se
        while ke >= ss and vals[ke] == 0:
            ke -= 1
        k = ss
        while k <= ke:
            i = 3 * (k - 1)
            e.encode(st, i, 0)
            while vals[k] == 0:
                e.encode(st, i + 1, 0)
                i += 3
                k += 1
            e.encode(st, i + 1, 1)
            v = vals[k]
            e.encode(self.fixed, 0, 0 if v > 0 else 1)
            self._magnitude(st, i + 2, abs(v) - 1,
                            189 if k <= self.K[t] else 217)
            k += 1
        if k <= se:
            e.encode(st, 3 * (k - 1), 1)

    def ac_refine(self, ci: int, zz: Sequence[int], ss: int, se: int,
                  ah: int, al: int):
        """Figure G.10: the bit ``al`` of AC coefficients ss..se."""
        t = self.ac_tbl[ci]
        st = self.ac_stats[t]
        e = self.e
        absv = [abs(int(zz[k])) for k in range(64)]
        ke = se
        while ke > 0 and absv[ke] >> al == 0:
            ke -= 1
        kex = ke
        while kex > 0 and absv[kex] >> ah == 0:
            kex -= 1
        k = ss
        while k <= ke:
            i = 3 * (k - 1)
            if k > kex:
                e.encode(st, i, 0)
            while True:
                v = absv[k] >> al
                if v:
                    if v >> 1:
                        e.encode(st, i + 2, v & 1)
                    else:
                        e.encode(st, i + 1, 1)
                        e.encode(self.fixed, 0, 0 if zz[k] >= 0 else 1)
                    break
                e.encode(st, i + 1, 0)
                i += 3
                k += 1
            k += 1
        if k <= se:
            e.encode(st, 3 * (k - 1), 1)


def arithmetic(data: bytes, progressive: bool = False, restart: int = 0,
               dac: Optional[Dict[str, Tuple[int, ...]]] = None) -> bytes:
    """The baseline Huffman file ``data`` re-encoded with the QM coder:
    SOF9 (one interleaved scan) or SOF10 (``jpeg_simple_progression``'s
    scans), a restart every ``restart`` MCUs if nonzero, and a DAC
    segment if ``dac`` gives ``L``, ``U`` (each DC table) and ``K`` (each
    AC table). Luma codes with bins 0, chroma with bins 1."""
    frame, headers, coefs = coefficients(data)
    n = len(frame.comps)
    tbl = [0] + [1] * (n - 1)
    L, U, K = [0, 0, 0, 0], [1, 1, 1, 1], [5, 5, 5, 5]
    out = bytearray(b"\xff\xd8")
    for m in (0xE0, 0xEE, 0xDB):
        for body in headers.get(m, []):
            out += _segment(m, body)
    if dac:
        L[:2], U[:2], K[:2] = dac["L"], dac["U"], dac["K"]
        body = bytearray()
        for t in range(2):
            body += bytes((t, (U[t] << 4) | L[t], 0x10 | t, K[t]))
        out += _segment(0xCC, bytes(body))
    out += _segment(0xCA if progressive else 0xC9, headers[0xC0][0])
    if restart:
        out += _segment(0xDD, restart.to_bytes(2, "big"))
    if progressive:
        script = PROGRESSION_YCC if n == 3 else PROGRESSION_GRAY
    else:
        script = ((None, 0, 63, 0, 0),)
    for comps, ss, se, ah, al in script:
        comps = tuple(range(n)) if comps is None else comps
        sos = bytearray([len(comps)])
        for ci in comps:
            sos += bytes((frame.comps[ci][0], (tbl[ci] << 4) | tbl[ci]))
        sos += bytes((ss, se, (ah << 4) | al))
        out += _segment(0xDA, bytes(sos))
        enc = QMEncoder()
        scan = _ArithScan(enc, n, tbl, tbl, L, U, K)
        units = _units(frame, comps)
        rst = 0
        for u, blocks in enumerate(units):
            if restart and u and u % restart == 0:
                enc.finish()
                enc.out += bytes((0xFF, 0xD0 + rst))
                rst = (rst + 1) & 7
                enc.reset()
                scan.restart()
            for ci, y, x in blocks:
                zz = coefs[ci][y, x]
                if not progressive:
                    scan.dc(ci, int(zz[0]))
                    scan.ac(ci, zz, 1, 63, 0)
                elif ss == 0 and ah == 0:
                    scan.dc(ci, int(zz[0]) >> al)
                elif ss == 0:
                    enc.encode(scan.fixed, 0, (int(zz[0]) >> al) & 1)
                elif ah == 0:
                    scan.ac(ci, zz, ss, se, al)
                else:
                    scan.ac_refine(ci, zz, ss, se, ah, al)
        enc.finish()
        out += enc.out
    return bytes(out + b"\xff\xd9")


def _units(frame: Frame, comps: Sequence[int]):
    """The scan's MCUs in order, each a list of (component, block row,
    block col): interleaved over the MCU grid, or one component's
    blocks."""
    if len(comps) == 1:
        ci = comps[0]
        bw, bh = frame.blocks[ci]
        return [[(ci, y, x)] for y in range(bh) for x in range(bw)]
    units = []
    for my in range(frame.mcus_y):
        for mx in range(frame.mcus_x):
            units.append([(ci, my * frame.comps[ci][2] + y,
                           mx * frame.comps[ci][1] + x)
                          for ci in comps
                          for y in range(frame.comps[ci][2])
                          for x in range(frame.comps[ci][1])])
    return units


def _std_dc_codes():
    codes, code, k = {}, 0, 0
    for length, count in enumerate(STD_DC_BITS, 1):
        for _ in range(count):
            codes[STD_DC_VALS[k]] = (code, length)
            code, k = code + 1, k + 1
        code <<= 1
    return codes


class _BitWriter:
    def __init__(self):
        self.out = bytearray()
        self.acc, self.n = 0, 0

    def put(self, value: int, length: int):
        self.acc = (self.acc << length) | (value & ((1 << length) - 1))
        self.n += length
        while self.n >= 8:
            b = (self.acc >> (self.n - 8)) & 0xFF
            self.out.append(b)
            if b == 0xFF:
                self.out.append(0)
            self.n -= 8
        self.acc &= (1 << self.n) - 1

    def flush(self):
        if self.n:
            self.put((1 << (8 - self.n)) - 1, 8 - self.n)


def _predict(sel: int, ra: int, rb: int, rc: int) -> int:
    return {1: ra, 2: rb, 3: rc, 4: ra + rb - rc, 5: ra + ((rb - rc) >> 1),
            6: rb + ((ra - rc) >> 1), 7: (ra + rb) >> 1}[sel]


def lossless(samples, predictor: int = 1, pt: int = 0,
             restart_rows: int = 0, colour: str = "gray",
             hv: Optional[Sequence[int]] = None) -> bytes:
    """A lossless (SOF3) 8-bit file: predictor 1-7 (T.81 Table H.1),
    point transform ``pt``, a restart every ``restart_rows`` MCU rows if
    nonzero, Huffman-coded with the standard DC table. ``samples`` is an
    (H, W) or (H, W, C) uint8 array, or with ``hv`` (each component's
    sampling byte, 0x11 by default) a list of each component's plane,
    ceil(H v / vmax) x ceil(W h / hmax) of it. ``colour`` "rgb" writes an
    Adobe segment of transform 0, "ycc" a JFIF header (the samples are
    then YCbCr, which only a YCbCr-converting decoder takes), "gray" and
    "none" neither."""
    if hv is None:
        a = np.asarray(samples)
        if a.ndim == 2:
            a = a[..., None]
        planes = [a[..., i] for i in range(a.shape[2])]
        hv = [0x11] * len(planes)
    else:
        planes = [np.asarray(p) for p in samples]
    n = len(planes)
    hs, vs = [x >> 4 for x in hv], [x & 15 for x in hv]
    hmax, vmax = max(hs), max(vs)
    # the image is the first component's plane scaled to full size
    H = planes[0].shape[0] * vmax // vs[0]
    W = planes[0].shape[1] * hmax // hs[0]
    mcus_x, mcus_y = -(-W // hmax), -(-H // vmax)
    if n == 1:
        mcus_x, mcus_y = planes[0].shape[1], planes[0].shape[0]
    out = bytearray(b"\xff\xd8")
    if colour == "ycc":
        out += _segment(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")
    elif colour == "rgb":
        out += _segment(0xEE, b"Adobe\x00\x64\x00\x00\x00\x00\x00")
    sof = bytearray([8]) + H.to_bytes(2, "big") + W.to_bytes(2, "big")
    sof.append(n)
    for ci in range(n):
        sof += bytes((ci + 1, hv[ci], 0))
    out += _segment(0xC3, bytes(sof))
    out += _segment(0xC4, bytes((0,)) + bytes(STD_DC_BITS)
                    + bytes(STD_DC_VALS))
    if restart_rows:
        out += _segment(0xDD, (restart_rows * mcus_x).to_bytes(2, "big"))
    sos = bytearray([n])
    for ci in range(n):
        sos += bytes((ci + 1, 0))
    sos += bytes((predictor, 0, pt))
    out += _segment(0xDA, bytes(sos))
    # each component's differences on its whole-MCU plane, the padding 0;
    # the first row of the scan and of each restart interval predicts from
    # the left, as the decoder undoes it
    rows_per_mcu = [1] if n == 1 else vs
    diffs = []
    for ci, p in enumerate(planes):
        x = p.astype(np.int64) >> pt
        ph, pw = x.shape
        d = np.zeros((mcus_y * rows_per_mcu[ci],
                      mcus_x * (1 if n == 1 else hs[ci])), np.int64)
        for y in range(ph):
            first = y % (restart_rows * rows_per_mcu[ci]) == 0 \
                if restart_rows else y == 0
            for col in range(pw):
                if first:
                    pred = (1 << (7 - pt)) if col == 0 else int(x[y, col - 1])
                elif col == 0:
                    pred = int(x[y - 1, 0])
                else:
                    pred = _predict(predictor, int(x[y, col - 1]),
                                    int(x[y - 1, col]), int(x[y - 1, col - 1]))
                v = (int(x[y, col]) - pred) & 0xFFFF
                d[y, col] = v - 0x10000 if v >= 0x8000 else v
        diffs.append(d)
    codes = _std_dc_codes()
    bw = _BitWriter()
    rst = 0
    for my in range(mcus_y):
        if restart_rows and my and my % restart_rows == 0:
            bw.flush()
            bw.out += bytes((0xFF, 0xD0 + rst))
            rst = (rst + 1) & 7
        for mx in range(mcus_x):
            for ci in range(n):
                h, v = (1, 1) if n == 1 else (hs[ci], vs[ci])
                for y in range(v):
                    for x in range(h):
                        dv = int(diffs[ci][my * v + y, mx * h + x])
                        s = abs(dv).bit_length()
                        code, length = codes[s]
                        bw.put(code, length)
                        if s and s < 16:
                            bw.put(dv if dv > 0 else dv - 1, s)
    bw.flush()
    return bytes(out + bw.out + b"\xff\xd9")


def edit_sof(data: bytes, marker: Optional[int] = None,
             precision: Optional[int] = None,
             sampling: Optional[Sequence[int]] = None,
             components: Optional[int] = None) -> bytes:
    """``data`` with its first frame header changed: the SOF ``marker``,
    the sample ``precision``, each component's ``sampling`` byte, or the
    number of ``components`` (extra ones copy the last, with new ids; the
    scans are left as they are)."""
    b = bytearray(data)
    i = next(i for i in range(2, len(b) - 1)
             if b[i] == 0xFF and 0xC0 <= b[i + 1] <= 0xCF
             and b[i + 1] not in (0xC4, 0xC8, 0xCC))
    if marker is not None:
        b[i + 1] = marker
    if precision is not None:
        b[i + 4] = precision
    if sampling is not None:
        for k, s in enumerate(sampling):
            b[i + 11 + 3 * k] = s
    if components is not None:
        n = b[i + 9]
        comps = bytearray(b[i + 10:i + 10 + 3 * n])
        while len(comps) // 3 < components:
            comps += bytes((200 + len(comps) // 3,)) + comps[-2:]
        comps = comps[:3 * components]
        seg = bytes(b[i + 4:i + 9]) + bytes((components,)) + bytes(comps)
        b[i + 2:i + 10 + 3 * n] = (len(seg) + 2).to_bytes(2, "big") + seg
    return bytes(b)
