"""Embedded-font glyph outlines for the built-in PDF renderer.

Parses the three embedded font-program formats a PDF FontDescriptor can
carry and converts glyph programs into flattened polygon contours (in
font units; the renderer scales by 1/unitsPerEm or 1/1000 into text
space):

- ``FontFile2`` — TrueType: ``glyf``/``loca`` quadratic outlines,
  ``cmap`` for simple-font code mapping, composite glyphs resolved
  recursively with their component transforms;
- ``FontFile3`` — CFF (Type1C / OpenType ``CFF ``): Type2 charstrings
  with local/global subrs and bias, charset for name→gid, built-in or
  standard encoding for code→gid; CID-keyed CFF maps CID→gid through
  the charset;
- ``FontFile``  — classic Type1: eexec + charstring decryption
  (r=55665/4330), Type1 charstring interpreter (flex collected via
  othersubrs is drawn as a polyline — flex exists for near-flat curves,
  so the approximation is sub-pixel at OCR dpi), seac accent
  composition, built-in ``/Encoding``.

The reference renders embedded glyph programs through the bundled
``hayro`` crate (reference: examples/utils/pdf.rs:8,81); this is the
from-scratch equivalent scoped to OCR rasterization: correct outlines
at correct positions. Fill-rule nuance (TrueType nonzero vs even-odd)
is ignored — cv2.fillPoly's even-odd rule renders counter-wound holes
correctly, which is what glyph winding is for.

Every parser raises on malformed input; callers (utils/pdf_render
FontInfo) catch and fall back to the Hershey approximation, so a broken
font program degrades the glyph shapes, never the render.

The port's copy of ``oar_ocr_tpu/utils/font_glyphs.py`` (:1-1197), line
for line; only this paragraph is new.
``tests/test_torch_host_copies.py`` holds it to the original.
"""

from __future__ import annotations

import re
import struct
from typing import Dict, List, Optional, Tuple

import numpy as np

Contours = List[np.ndarray]          # each (N, 2) float64, font units

# StandardEncoding / CFF standard-string names for the printable ASCII
# range: SID n (1..95) == StandardEncoding code 31+n. (Type1 and CFF
# share this table by construction.)
_ASCII_NAMES = (
    "space exclam quotedbl numbersign dollar percent ampersand "
    "quoteright parenleft parenright asterisk plus comma hyphen period "
    "slash zero one two three four five six seven eight nine colon "
    "semicolon less equal greater question at A B C D E F G H I J K L M "
    "N O P Q R S T U V W X Y Z bracketleft backslash bracketright "
    "asciicircum underscore quoteleft a b c d e f g h i j k l m n o p q "
    "r s t u v w x y z braceleft bar braceright asciitilde").split()

STANDARD_ENCODING: Dict[int, str] = {
    32 + i: n for i, n in enumerate(_ASCII_NAMES)}
# name → unicode char for the same range (glyph lookup via TrueType cmap)
NAME_TO_UNICODE: Dict[str, str] = {
    n: chr(32 + i) for i, n in enumerate(_ASCII_NAMES)}
NAME_TO_UNICODE["quoteright"] = "’"
NAME_TO_UNICODE["quoteleft"] = "‘"


def _flatten_quad(p0, p1, p2, segs: int = 4):
    """Quadratic bézier → ``segs`` line segments (excluding p0)."""
    out = []
    for i in range(1, segs + 1):
        t = i / segs
        mt = 1.0 - t
        out.append((mt * mt * p0[0] + 2 * mt * t * p1[0] + t * t * p2[0],
                    mt * mt * p0[1] + 2 * mt * t * p1[1] + t * t * p2[1]))
    return out


def _flatten_cubic(p0, p1, p2, p3, segs: int = 6):
    out = []
    for i in range(1, segs + 1):
        t = i / segs
        mt = 1.0 - t
        out.append((
            mt**3 * p0[0] + 3 * mt**2 * t * p1[0]
            + 3 * mt * t**2 * p2[0] + t**3 * p3[0],
            mt**3 * p0[1] + 3 * mt**2 * t * p1[1]
            + 3 * mt * t**2 * p2[1] + t**3 * p3[1]))
    return out


# ============================ TrueType ============================

class TrueTypeGlyphs:
    """``glyf``-flavored TrueType/OpenType outline reader."""

    def __init__(self, data: bytes):
        self.data = data
        self.tables: Dict[bytes, Tuple[int, int]] = {}
        tag = data[:4]
        if tag == b"ttcf":                       # collection: first font
            (off,) = struct.unpack(">I", data[12:16])
            self._parse_dir(off)
        else:
            self._parse_dir(0)
        if b"glyf" not in self.tables:
            raise ValueError("no glyf table (CFF-flavored font?)")
        head = self._table(b"head")
        self.units_per_em = struct.unpack(">H", head[18:20])[0] or 1000
        self.loca_long = struct.unpack(">h", head[50:52])[0] == 1
        maxp = self._table(b"maxp")
        self.num_glyphs = struct.unpack(">H", maxp[4:6])[0]
        loca = self._table(b"loca")
        n = self.num_glyphs + 1
        if self.loca_long:
            self.loca = struct.unpack(f">{n}I", loca[:4 * n])
        else:
            self.loca = tuple(v * 2 for v in
                              struct.unpack(f">{n}H", loca[:2 * n]))
        self.glyf = self._table(b"glyf")
        self._cmap = self._parse_cmap() if b"cmap" in self.tables else {}
        self._cache: Dict[int, Contours] = {}

    def _parse_dir(self, base: int):
        num = struct.unpack(">H", self.data[base + 4:base + 6])[0]
        for i in range(num):
            o = base + 12 + 16 * i
            tag = self.data[o:o + 4]
            off, ln = struct.unpack(">II", self.data[o + 8:o + 16])
            self.tables[tag] = (off, ln)

    def _table(self, tag: bytes) -> bytes:
        off, ln = self.tables[tag]
        return self.data[off:off + ln]

    # ---- cmap ----
    def _parse_cmap(self) -> Dict[int, int]:
        cm = self._table(b"cmap")
        n = struct.unpack(">H", cm[2:4])[0]
        subs = {}
        for i in range(n):
            pid, eid, off = struct.unpack(">HHI", cm[4 + 8 * i:12 + 8 * i])
            subs[(pid, eid)] = off
        self.symbol_cmap = (3, 0) in subs and (3, 1) not in subs
        for key in ((3, 1), (0, 3), (0, 4), (0, 6), (0, 0), (3, 0),
                    (1, 0)):
            if key in subs:
                try:
                    return self._parse_cmap_sub(cm, subs[key])
                except Exception:
                    continue
        return {}

    def _parse_cmap_sub(self, cm: bytes, off: int) -> Dict[int, int]:
        fmt = struct.unpack(">H", cm[off:off + 2])[0]
        out: Dict[int, int] = {}
        if fmt == 0:
            for c in range(256):
                g = cm[off + 6 + c]
                if g:
                    out[c] = g
        elif fmt == 4:
            seg2 = struct.unpack(">H", cm[off + 6:off + 8])[0]
            seg = seg2 // 2
            ends = struct.unpack(f">{seg}H", cm[off + 14:off + 14 + seg2])
            s0 = off + 16 + seg2
            starts = struct.unpack(f">{seg}H", cm[s0:s0 + seg2])
            d0 = s0 + seg2
            deltas = struct.unpack(f">{seg}h", cm[d0:d0 + seg2])
            r0 = d0 + seg2
            ranges = struct.unpack(f">{seg}H", cm[r0:r0 + seg2])
            for i in range(seg):
                if starts[i] == 0xFFFF:
                    continue
                for c in range(starts[i], min(ends[i], 0xFFFE) + 1):
                    if ranges[i] == 0:
                        g = (c + deltas[i]) & 0xFFFF
                    else:
                        gi = r0 + 2 * i + ranges[i] + 2 * (c - starts[i])
                        if gi + 2 > len(cm):
                            continue
                        g = struct.unpack(">H", cm[gi:gi + 2])[0]
                        if g:
                            g = (g + deltas[i]) & 0xFFFF
                    if g:
                        out[c] = g
        elif fmt == 6:
            first, cnt = struct.unpack(">HH", cm[off + 6:off + 10])
            for i in range(cnt):
                g = struct.unpack(
                    ">H", cm[off + 10 + 2 * i:off + 12 + 2 * i])[0]
                if g:
                    out[first + i] = g
        elif fmt == 12:
            (ngroups,) = struct.unpack(">I", cm[off + 12:off + 16])
            for i in range(min(ngroups, 10000)):
                s, e, g = struct.unpack(
                    ">III", cm[off + 16 + 12 * i:off + 28 + 12 * i])
                for c in range(s, min(e, s + 0xFFFF) + 1):
                    out[c] = g + (c - s)
        else:
            raise ValueError(f"cmap format {fmt}")
        return out

    def gid_for_unicode(self, ch: str) -> int:
        if not ch:
            return 0
        cp = ord(ch[0])
        g = self._cmap.get(cp, 0)
        if not g and (self.symbol_cmap or not self._cmap):
            g = self._cmap.get(0xF000 | (cp & 0xFF), 0)
        return g

    # ---- outlines ----
    def contours_for_gid(self, gid: int, depth: int = 0) -> Contours:
        if gid in self._cache:
            return self._cache[gid]
        if gid < 0 or gid >= self.num_glyphs or depth > 5:
            return []
        start, end = self.loca[gid], self.loca[gid + 1]
        if end <= start:
            return []
        g = self.glyf[start:end]
        (ncont,) = struct.unpack(">h", g[:2])
        if ncont >= 0:
            out = self._simple_glyph(g, ncont)
        else:
            out = self._composite_glyph(g, depth)
        self._cache[gid] = out
        return out

    def _simple_glyph(self, g: bytes, ncont: int) -> Contours:
        ends = struct.unpack(f">{ncont}H", g[10:10 + 2 * ncont])
        npts = (ends[-1] + 1) if ncont else 0
        p = 10 + 2 * ncont
        (ilen,) = struct.unpack(">H", g[p:p + 2])
        p += 2 + ilen
        flags = []
        while len(flags) < npts:
            f = g[p]
            p += 1
            flags.append(f)
            if f & 8:                            # repeat
                r = g[p]
                p += 1
                flags.extend([f] * r)
        flags = flags[:npts]
        xs, x = [], 0
        for f in flags:
            if f & 2:
                dx = g[p]
                p += 1
                x += dx if f & 16 else -dx
            elif not f & 16:
                (dx,) = struct.unpack(">h", g[p:p + 2])
                p += 2
                x += dx
            xs.append(x)
        ys, y = [], 0
        for f in flags:
            if f & 4:
                dy = g[p]
                p += 1
                y += dy if f & 32 else -dy
            elif not f & 32:
                (dy,) = struct.unpack(">h", g[p:p + 2])
                p += 2
                y += dy
            ys.append(y)
        out: Contours = []
        s = 0
        for e in ends:
            pts = [(xs[i], ys[i]) for i in range(s, e + 1)]
            ons = [bool(flags[i] & 1) for i in range(s, e + 1)]
            s = e + 1
            if len(pts) < 2:
                continue
            out.append(np.array(self._quad_contour(pts, ons), np.float64))
        return out

    @staticmethod
    def _quad_contour(pts, ons):
        """TrueType quadratic contour → polyline (implied on-curve
        midpoints between consecutive off-curve points)."""
        n = len(pts)
        # rotate so we start on-curve (or synthesize a start midpoint)
        if True in ons:
            k = ons.index(True)
            pts = pts[k:] + pts[:k]
            ons = ons[k:] + ons[:k]
            start = pts[0]
        else:
            start = ((pts[0][0] + pts[-1][0]) / 2,
                     (pts[0][1] + pts[-1][1]) / 2)
            ons = [True] + ons
            pts = [start] + pts
            n += 1
        poly = [start]
        i = 1
        cur = start
        while i <= n:
            p = pts[i % n]
            on = ons[i % n] if i < n else True
            if i == n:
                p = start
            if on:
                poly.append(p)
                cur = p
                i += 1
            else:
                nxt = pts[(i + 1) % n] if i + 1 <= n else start
                non = ons[(i + 1) % n] if i + 1 < n else True
                end = nxt if non else ((p[0] + nxt[0]) / 2,
                                       (p[1] + nxt[1]) / 2)
                poly.extend(_flatten_quad(cur, p, end))
                cur = end
                i += 2 if non else 1
        return poly

    def _composite_glyph(self, g: bytes, depth: int) -> Contours:
        out: Contours = []
        p = 10
        while True:
            flags, gi = struct.unpack(">HH", g[p:p + 4])
            p += 4
            if flags & 1:                        # ARG_1_AND_2_ARE_WORDS
                a1, a2 = struct.unpack(">hh", g[p:p + 4])
                p += 4
            else:
                a1, a2 = struct.unpack(">bb", g[p:p + 2])
                p += 2
            m = np.eye(2)
            if flags & 8:                        # WE_HAVE_A_SCALE
                (s,) = struct.unpack(">h", g[p:p + 2])
                p += 2
                m = np.eye(2) * (s / 16384.0)
            elif flags & 0x40:                   # X_AND_Y_SCALE
                sx, sy = struct.unpack(">hh", g[p:p + 4])
                p += 4
                m = np.diag([sx / 16384.0, sy / 16384.0])
            elif flags & 0x80:                   # TWO_BY_TWO
                a, b, c, d = struct.unpack(">hhhh", g[p:p + 8])
                p += 8
                m = np.array([[a, b], [c, d]]) / 16384.0
            dx, dy = (a1, a2) if flags & 2 else (0, 0)  # XY values
            # spec entry order (xscale, scale01, scale10, yscale) with
            # x' = a·x + c·y, y' = b·x + d·y — row-vector p @ [[a,b],
            # [c,d]] applies exactly that (no transpose)
            for c in self.contours_for_gid(gi, depth + 1):
                out.append(c @ m + np.array([dx, dy], np.float64))
            if not flags & 0x20:                 # MORE_COMPONENTS
                break
        return out


# ============================== CFF ==============================

def _cff_index(data: bytes, pos: int) -> Tuple[List[bytes], int]:
    (count,) = struct.unpack(">H", data[pos:pos + 2])
    if count == 0:
        return [], pos + 2
    osz = data[pos + 2]
    offs = []
    p = pos + 3
    for _ in range(count + 1):
        offs.append(int.from_bytes(data[p:p + osz], "big"))
        p += osz
    base = p - 1
    items = [data[base + offs[i]:base + offs[i + 1]]
             for i in range(count)]
    return items, base + offs[-1]


def _cff_dict(data: bytes) -> Dict[int, list]:
    out: Dict[int, list] = {}
    operands: list = []
    i = 0
    while i < len(data):
        b = data[i]
        if b <= 21:
            op = b
            i += 1
            if b == 12:
                op = 0x0C00 | data[i]
                i += 1
            out[op] = operands
            operands = []
        elif b == 28:
            operands.append(struct.unpack(">h", data[i + 1:i + 3])[0])
            i += 3
        elif b == 29:
            operands.append(struct.unpack(">i", data[i + 1:i + 5])[0])
            i += 5
        elif b == 30:                            # real number
            s = ""
            i += 1
            nib = "0123456789.EE?-?"
            done = False
            while i < len(data) and not done:
                for h in (data[i] >> 4, data[i] & 15):
                    if h == 15:
                        done = True
                        break
                    if h == 12:
                        s += "E-"
                    else:
                        s += nib[h]
                i += 1
            try:
                operands.append(float(s))
            except ValueError:
                operands.append(0.0)
        elif 32 <= b <= 246:
            operands.append(b - 139)
            i += 1
        elif 247 <= b <= 250:
            operands.append((b - 247) * 256 + data[i + 1] + 108)
            i += 2
        elif 251 <= b <= 254:
            operands.append(-(b - 251) * 256 - data[i + 1] - 108)
            i += 2
        else:
            i += 1
    return out


def _subr_bias(n: int) -> int:
    return 107 if n < 1240 else (1131 if n < 33900 else 32768)


class CFFGlyphs:
    """CFF / Type1C outline reader (Type2 charstrings)."""

    units_per_em = 1000.0

    def __init__(self, data: bytes):
        if data[:4] in (b"OTTO", b"\x00\x01\x00\x00", b"true"):
            # OpenType wrapper: pull the CFF table
            num = struct.unpack(">H", data[4:6])[0]
            for i in range(num):
                o = 12 + 16 * i
                if data[o:o + 4] == b"CFF ":
                    off, ln = struct.unpack(">II", data[o + 8:o + 16])
                    data = data[off:off + ln]
                    break
            else:
                raise ValueError("OpenType font has no CFF table")
        self.data = data
        hdr_size = data[2]
        _, p = _cff_index(data, hdr_size)              # Name INDEX
        tops, p = _cff_index(data, p)                  # Top DICT INDEX
        self.strings, p = _cff_index(data, p)          # String INDEX
        self.gsubrs, _ = _cff_index(data, p)           # Global Subr INDEX
        top = _cff_dict(tops[0])
        (cs_off,) = top.get(17, [0])
        self.charstrings, _ = _cff_index(data, int(cs_off))
        self.nglyphs = len(self.charstrings)
        self.is_cid = 0x0C1E in top                    # ROS
        self.subrs: List[bytes] = []
        self.fd_subrs: List[List[bytes]] = []
        self.fd_select: Optional[List[int]] = None
        priv = top.get(18)
        if priv and len(priv) == 2:
            psz, poff = int(priv[0]), int(priv[1])
            pdict = _cff_dict(data[poff:poff + psz])
            if 19 in pdict:                            # Subrs (private)
                self.subrs, _ = _cff_index(
                    data, poff + int(pdict[19][0]))
        elif self.is_cid and 0x0C24 in top:            # FDArray
            # every FD keeps its OWN local-subr table; charstrings are
            # routed to their FD via FDSelect (a callsubr index is only
            # meaningful against the owning FD's table + bias)
            fds, _ = _cff_index(data, int(top[0x0C24][0]))
            for fd in fds:
                fd_subrs: List[bytes] = []
                fdd = _cff_dict(fd)
                pv = fdd.get(18)
                if pv and len(pv) == 2:
                    psz, poff = int(pv[0]), int(pv[1])
                    pdict = _cff_dict(data[poff:poff + psz])
                    if 19 in pdict:
                        fd_subrs, _ = _cff_index(
                            data, poff + int(pdict[19][0]))
                self.fd_subrs.append(fd_subrs)
            if 0x0C25 in top:                          # FDSelect
                self.fd_select = self._parse_fd_select(
                    int(top[0x0C25][0]))
            if self.fd_subrs:
                self.subrs = self.fd_subrs[0]          # default FD 0
        self._parse_charset(int(top.get(15, [0])[0]))
        self._parse_encoding(int(top.get(16, [0])[0]))
        self._cache: Dict[int, Contours] = {}

    def _sid_name(self, sid: int) -> str:
        if sid == 0:
            return ".notdef"
        if 1 <= sid <= 95:
            return _ASCII_NAMES[sid - 1]
        if sid >= 391 and sid - 391 < len(self.strings):
            return self.strings[sid - 391].decode("latin-1")
        return f"sid{sid}"

    def _parse_charset(self, off: int):
        self.name_to_gid: Dict[str, int] = {".notdef": 0}
        self.cid_to_gid: Dict[int, int] = {0: 0}
        if off == 0:                                   # ISOAdobe order
            for gid in range(1, self.nglyphs):
                self.name_to_gid[self._sid_name(gid)] = gid
                self.cid_to_gid[gid] = gid
            return
        d = self.data
        fmt = d[off]
        sids = [0]
        p = off + 1
        if fmt == 0:
            for _ in range(self.nglyphs - 1):
                sids.append(struct.unpack(">H", d[p:p + 2])[0])
                p += 2
        elif fmt in (1, 2):
            while len(sids) < self.nglyphs:
                (first,) = struct.unpack(">H", d[p:p + 2])
                if fmt == 1:
                    nleft = d[p + 2]
                    p += 3
                else:
                    (nleft,) = struct.unpack(">H", d[p + 2:p + 4])
                    p += 4
                for k in range(nleft + 1):
                    sids.append(first + k)
        for gid, sid in enumerate(sids[:self.nglyphs]):
            self.cid_to_gid[sid] = gid
            if not self.is_cid:
                self.name_to_gid[self._sid_name(sid)] = gid

    def _parse_encoding(self, off: int):
        self.code_to_gid: Dict[int, int] = {}
        if off in (0, 1):                              # standard/expert
            for code, name in STANDARD_ENCODING.items():
                g = self.name_to_gid.get(name)
                if g:
                    self.code_to_gid[code] = g
            return
        d = self.data
        fmt = d[off] & 0x7F
        if fmt == 0:
            n = d[off + 1]
            for i in range(n):
                self.code_to_gid[d[off + 2 + i]] = i + 1
        elif fmt == 1:
            nr = d[off + 1]
            gid = 1
            p = off + 2
            for _ in range(nr):
                first, nleft = d[p], d[p + 1]
                p += 2
                for k in range(nleft + 1):
                    self.code_to_gid[first + k] = gid
                    gid += 1

    def _parse_fd_select(self, off: int) -> Optional[List[int]]:
        """FDSelect (CFF spec §19): glyph → FDArray index. Format 0 is
        one byte per glyph; format 3 is (first, fd) ranges + sentinel."""
        d = self.data
        if off <= 0 or off >= len(d):
            return None
        fmt = d[off]
        sel = [0] * self.nglyphs
        if fmt == 0:
            for gid in range(self.nglyphs):
                sel[gid] = d[off + 1 + gid]
        elif fmt == 3:
            (nr,) = struct.unpack(">H", d[off + 1:off + 3])
            p = off + 3
            for _ in range(nr):
                (first,) = struct.unpack(">H", d[p:p + 2])
                fd = d[p + 2]
                (nxt,) = struct.unpack(">H", d[p + 3:p + 5])
                for gid in range(first, min(nxt, self.nglyphs)):
                    sel[gid] = fd
                p += 3
        else:
            return None
        return sel

    def _subrs_for_gid(self, gid: int) -> List[bytes]:
        if self.fd_subrs:
            fd = (self.fd_select[gid]
                  if self.fd_select and gid < len(self.fd_select) else 0)
            if 0 <= fd < len(self.fd_subrs):
                return self.fd_subrs[fd]
        return self.subrs

    def gid_for_name(self, name: str) -> int:
        return self.name_to_gid.get(name, 0)

    def gid_for_cid(self, cid: int) -> int:
        return self.cid_to_gid.get(cid, 0)

    def contours_for_gid(self, gid: int) -> Contours:
        if gid in self._cache:
            return self._cache[gid]
        if gid < 0 or gid >= self.nglyphs:
            return []
        out = _Type2Interp(self, self._subrs_for_gid(gid)).run(
            self.charstrings[gid])
        self._cache[gid] = out
        return out


class _Type2Interp:
    """Type2 charstring interpreter → polygon contours."""

    def __init__(self, font: CFFGlyphs,
                 subrs: Optional[List[bytes]] = None):
        self.font = font
        self.subrs = font.subrs if subrs is None else subrs
        self.lbias = _subr_bias(len(self.subrs))
        self.gbias = _subr_bias(len(font.gsubrs))

    def run(self, cs: bytes) -> Contours:
        self.stack: List[float] = []
        self.contours: Contours = []
        self.cur: List[Tuple[float, float]] = []
        self.x = self.y = 0.0
        self.nstems = 0
        self.width_done = False
        self._exec(cs, 0)
        self._close()
        return self.contours

    def _close(self):
        if len(self.cur) >= 2:
            self.contours.append(np.array(self.cur, np.float64))
        self.cur = []

    def _moveto(self, x, y):
        self._close()
        self.x, self.y = x, y
        self.cur = [(x, y)]

    def _lineto(self, x, y):
        self.x, self.y = x, y
        self.cur.append((x, y))

    def _curveto(self, x1, y1, x2, y2, x3, y3):
        self.cur.extend(_flatten_cubic(
            (self.x, self.y), (x1, y1), (x2, y2), (x3, y3)))
        self.x, self.y = x3, y3

    def _take_width(self, even: bool):
        """First stack-clearing operator may carry a leading width."""
        if not self.width_done:
            self.width_done = True
            if len(self.stack) % 2 == (0 if even else 1):
                pass
            else:
                self.stack.pop(0)

    def _exec(self, cs: bytes, depth: int) -> bool:
        if depth > 10:
            return True
        i = 0
        st = self.stack
        while i < len(cs):
            b = cs[i]
            if b >= 32 or b == 28:
                if b == 28:
                    st.append(struct.unpack(">h", cs[i + 1:i + 3])[0])
                    i += 3
                elif b <= 246:
                    st.append(b - 139)
                    i += 1
                elif b <= 250:
                    st.append((b - 247) * 256 + cs[i + 1] + 108)
                    i += 2
                elif b <= 254:
                    st.append(-(b - 251) * 256 - cs[i + 1] - 108)
                    i += 2
                else:                            # 255: 16.16 fixed
                    st.append(struct.unpack(
                        ">i", cs[i + 1:i + 5])[0] / 65536.0)
                    i += 5
                continue
            i += 1
            if b in (1, 3, 18, 23):              # stems
                self._take_width(True)
                self.nstems += len(st) // 2
                st.clear()
            elif b in (19, 20):                  # hintmask/cntrmask
                self._take_width(True)
                self.nstems += len(st) // 2
                st.clear()
                i += (self.nstems + 7) // 8
            elif b == 21:                        # rmoveto
                self._take_width(len(st) % 2 == 0)
                if len(st) >= 2:
                    self._moveto(self.x + st[-2], self.y + st[-1])
                st.clear()
            elif b == 22:                        # hmoveto
                self._take_width(len(st) % 2 == 1)
                if st:
                    self._moveto(self.x + st[-1], self.y)
                st.clear()
            elif b == 4:                         # vmoveto
                self._take_width(len(st) % 2 == 1)
                if st:
                    self._moveto(self.x, self.y + st[-1])
                st.clear()
            elif b == 5:                         # rlineto
                for j in range(0, len(st) - 1, 2):
                    self._lineto(self.x + st[j], self.y + st[j + 1])
                st.clear()
            elif b in (6, 7):                    # hlineto / vlineto
                horiz = b == 6
                for v in st:
                    if horiz:
                        self._lineto(self.x + v, self.y)
                    else:
                        self._lineto(self.x, self.y + v)
                    horiz = not horiz
                st.clear()
            elif b == 8:                         # rrcurveto
                for j in range(0, len(st) - 5, 6):
                    self._rel_curve(*st[j:j + 6])
                st.clear()
            elif b == 24:                        # rcurveline
                j = 0
                while j + 6 <= len(st) - 2:
                    self._rel_curve(*st[j:j + 6])
                    j += 6
                if j + 2 <= len(st):
                    self._lineto(self.x + st[j], self.y + st[j + 1])
                st.clear()
            elif b == 25:                        # rlinecurve
                j = 0
                while len(st) - j > 6:
                    self._lineto(self.x + st[j], self.y + st[j + 1])
                    j += 2
                if j + 6 <= len(st):
                    self._rel_curve(*st[j:j + 6])
                st.clear()
            elif b == 26 or b == 27:             # vvcurveto / hhcurveto
                j = 0
                d1 = 0.0
                if len(st) % 4 == 1:
                    d1 = st[0]
                    j = 1
                while j + 4 <= len(st):
                    a, bb, c, d = st[j:j + 4]
                    if b == 26:                  # vv
                        self._rel_curve(d1, a, bb, c, 0, d)
                    else:                        # hh
                        self._rel_curve(a, d1, bb, c, d, 0)
                    d1 = 0.0
                    j += 4
                st.clear()
            elif b in (30, 31):                  # vhcurveto / hvcurveto
                horiz = b == 31
                j = 0
                while j + 4 <= len(st):
                    last = j + 8 > len(st)
                    extra = st[j + 4] if (last and j + 5 == len(st)) \
                        else 0.0
                    a, bb, c, d = st[j:j + 4]
                    if horiz:
                        self._rel_curve(a, 0, bb, c, extra, d)
                    else:
                        self._rel_curve(0, a, bb, c, d, extra)
                    horiz = not horiz
                    j += 4
                st.clear()
            elif b == 10:                        # callsubr
                if st:
                    idx = int(st.pop()) + self.lbias
                    if 0 <= idx < len(self.subrs):
                        if self._exec(self.subrs[idx], depth + 1):
                            return True
            elif b == 29:                        # callgsubr
                if st:
                    idx = int(st.pop()) + self.gbias
                    if 0 <= idx < len(self.font.gsubrs):
                        if self._exec(self.font.gsubrs[idx], depth + 1):
                            return True
            elif b == 11:                        # return
                return False
            elif b == 14:                        # endchar
                self._take_width(True)
                st.clear()
                return True
            elif b == 12:                        # escape
                b2 = cs[i]
                i += 1
                if b2 == 35 and len(st) >= 13:   # flex (fd ignored)
                    self._rel_curve(*st[0:6])
                    self._rel_curve(*st[6:12])
                elif b2 == 34 and len(st) >= 7:  # hflex
                    sy = self.y
                    self._rel_curve(st[0], 0, st[1], st[2], st[3], 0)
                    self._rel_curve(st[4], 0, st[5],
                                    sy - self.y, st[6], 0)
                elif b2 == 36 and len(st) >= 9:  # hflex1
                    sy = self.y
                    self._rel_curve(st[0], st[1], st[2], st[3],
                                    st[4], 0)
                    self._rel_curve(st[5], 0, st[6], st[7], st[8],
                                    sy - (self.y + st[7]))
                elif b2 == 37 and len(st) >= 11:  # flex1
                    sx, sy = self.x, self.y
                    dx = st[0] + st[2] + st[4] + st[6] + st[8]
                    dy = st[1] + st[3] + st[5] + st[7] + st[9]
                    self._rel_curve(*st[0:6])
                    if abs(dx) > abs(dy):
                        self._rel_curve(
                            st[6], st[7], st[8], st[9], st[10],
                            sy - (self.y + st[7] + st[9]))
                    else:
                        self._rel_curve(
                            st[6], st[7], st[8], st[9],
                            sx - (self.x + st[6] + st[8]), st[10])
                st.clear()
            else:
                st.clear()
        return False

    def _rel_curve(self, dx1, dy1, dx2, dy2, dx3, dy3):
        x1, y1 = self.x + dx1, self.y + dy1
        x2, y2 = x1 + dx2, y1 + dy2
        self._curveto(x1, y1, x2, y2, x2 + dx3, y2 + dy3)


# ============================= Type1 =============================

def _eexec_decrypt(data: bytes, r: int, skip: int) -> bytes:
    c1, c2 = 52845, 22719
    out = bytearray()
    for b in data:
        out.append(b ^ (r >> 8))
        r = ((b + r) * c1 + c2) & 0xFFFF
    return bytes(out[skip:])


class Type1Glyphs:
    """Classic Type1 font program reader (PDF FontFile / PFB / PFA)."""

    units_per_em = 1000.0

    def __init__(self, data: bytes):
        if data[:1] == b"\x80":                  # PFB segments
            parts = []
            p = 0
            while p < len(data) and data[p] == 0x80:
                t = data[p + 1]
                if t == 3:
                    break
                (ln,) = struct.unpack("<I", data[p + 2:p + 6])
                parts.append(data[p + 6:p + 6 + ln])
                p += 6 + ln
            data = b"".join(parts)
        m = data.find(b"eexec")
        if m < 0:
            raise ValueError("no eexec section")
        clear = data[:m]
        enc = data[m + 5:].lstrip(b"\r\n\t ")
        # hex form: first 4 bytes all hex digits
        if all(c in b"0123456789abcdefABCDEF" for c in enc[:4]):
            hx = re.sub(rb"[^0-9A-Fa-f]", b"", enc)
            enc = bytes.fromhex(hx.decode("ascii"))
        priv = _eexec_decrypt(enc, 55665, 4)
        m2 = re.search(rb"/lenIV\s+(\d+)", priv)
        self.len_iv = int(m2.group(1)) if m2 else 4
        self.subrs: List[bytes] = []
        ms = re.search(rb"/Subrs\s+(\d+)", priv)
        if ms:
            pos = ms.end()
            for mm in re.finditer(
                    rb"dup\s+(\d+)\s+(\d+)\s+(?:RD|-\|)[ ]", priv[pos:]):
                idx, n = int(mm.group(1)), int(mm.group(2))
                s = pos + mm.end()
                while len(self.subrs) <= idx:
                    self.subrs.append(b"")
                self.subrs[idx] = _eexec_decrypt(
                    priv[s:s + n], 4330, self.len_iv)
                if idx > 4000:
                    break
        self.charstrings: Dict[str, bytes] = {}
        mc = priv.find(b"/CharStrings")
        if mc < 0:
            raise ValueError("no CharStrings")
        pos = mc
        for mm in re.finditer(
                rb"/([^\s/{}()\[\]<>]+)\s+(\d+)\s+(?:RD|-\|)[ ]",
                priv[pos:]):
            name = mm.group(1).decode("latin-1")
            n = int(mm.group(2))
            s = pos + mm.end()
            self.charstrings[name] = _eexec_decrypt(
                priv[s:s + n], 4330, self.len_iv)
        # built-in encoding from the cleartext header
        self.encoding: Dict[int, str] = {}
        if re.search(rb"/Encoding\s+StandardEncoding", clear):
            self.encoding = dict(STANDARD_ENCODING)
        else:
            for mm in re.finditer(
                    rb"dup\s+(\d+)\s*/([^\s/{}()\[\]<>]+)\s+put", clear):
                self.encoding[int(mm.group(1))] = \
                    mm.group(2).decode("latin-1")
        self._cache: Dict[str, Contours] = {}

    def contours_for_name(self, name: str) -> Contours:
        if name in self._cache:
            return self._cache[name]
        cs = self.charstrings.get(name)
        if cs is None:
            return []
        out = _Type1Interp(self).run(cs)
        self._cache[name] = out
        return out

    def name_for_code(self, code: int) -> Optional[str]:
        return self.encoding.get(code)


class _Type1Interp:
    """Type1 charstring interpreter → polygon contours. Flex points
    (othersubr 0/1/2 protocol) are drawn as a polyline."""

    def __init__(self, font: Type1Glyphs):
        self.font = font

    def run(self, cs: bytes) -> Contours:
        self.stack: List[float] = []
        self.ps_stack: List[float] = []
        self.contours: Contours = []
        self.cur: List[Tuple[float, float]] = []
        self.x = self.y = 0.0
        self.sbx = 0.0
        self.in_flex = False
        self._exec(cs, 0)
        self._close()
        return self.contours

    def _close(self):
        if len(self.cur) >= 2:
            self.contours.append(np.array(self.cur, np.float64))
        self.cur = []

    def _exec(self, cs: bytes, depth: int) -> bool:
        if depth > 10:
            return True
        st = self.stack
        i = 0
        while i < len(cs):
            b = cs[i]
            if b >= 32:
                if b <= 246:
                    st.append(b - 139)
                    i += 1
                elif b <= 250:
                    st.append((b - 247) * 256 + cs[i + 1] + 108)
                    i += 2
                elif b <= 254:
                    st.append(-(b - 251) * 256 - cs[i + 1] - 108)
                    i += 2
                else:
                    st.append(struct.unpack(">i", cs[i + 1:i + 5])[0])
                    i += 5
                continue
            i += 1
            if b == 13:                          # hsbw: sbx wx
                if len(st) >= 2:
                    self.sbx = st[0]
                    self.x = st[0]
                st.clear()
            elif b == 9:                         # closepath
                if len(self.cur) > 1:
                    self.cur.append(self.cur[0])
                self._close()
                self.cur = [(self.x, self.y)]
            elif b == 21:                        # rmoveto
                if len(st) >= 2:
                    self.x += st[-2]
                    self.y += st[-1]
                    if self.in_flex:
                        self.cur.append((self.x, self.y))
                    else:
                        self._close()
                        self.cur = [(self.x, self.y)]
                st.clear()
            elif b == 22:                        # hmoveto
                if st:
                    self.x += st[-1]
                    if self.in_flex:
                        self.cur.append((self.x, self.y))
                    else:
                        self._close()
                        self.cur = [(self.x, self.y)]
                st.clear()
            elif b == 4:                         # vmoveto
                if st:
                    self.y += st[-1]
                    if self.in_flex:
                        self.cur.append((self.x, self.y))
                    else:
                        self._close()
                        self.cur = [(self.x, self.y)]
                st.clear()
            elif b == 5:                         # rlineto
                if len(st) >= 2:
                    self.x += st[-2]
                    self.y += st[-1]
                    self.cur.append((self.x, self.y))
                st.clear()
            elif b == 6:                         # hlineto
                if st:
                    self.x += st[-1]
                    self.cur.append((self.x, self.y))
                st.clear()
            elif b == 7:                         # vlineto
                if st:
                    self.y += st[-1]
                    self.cur.append((self.x, self.y))
                st.clear()
            elif b == 8:                         # rrcurveto
                if len(st) >= 6:
                    self._rel_curve(*st[-6:])
                st.clear()
            elif b == 30:                        # vhcurveto
                if len(st) >= 4:
                    self._rel_curve(0, st[-4], st[-3], st[-2],
                                    st[-1], 0)
                st.clear()
            elif b == 31:                        # hvcurveto
                if len(st) >= 4:
                    self._rel_curve(st[-4], 0, st[-3], st[-2],
                                    0, st[-1])
                st.clear()
            elif b in (1, 3):                    # hstem / vstem
                st.clear()
            elif b == 10:                        # callsubr
                if st:
                    idx = int(st.pop())
                    if 0 <= idx < len(self.font.subrs):
                        if self._exec(self.font.subrs[idx], depth + 1):
                            return True
            elif b == 11:
                return False
            elif b == 14:                        # endchar
                return True
            elif b == 12:
                b2 = cs[i]
                i += 1
                if b2 == 12:                     # div
                    if len(st) >= 2:
                        d = st.pop()
                        n = st.pop()
                        st.append(n / d if d else 0.0)
                elif b2 == 6:                    # seac: asb adx ady bchar achar
                    if len(st) >= 5:
                        asb, adx, ady, bchar, achar = st[-5:]
                        st.clear()
                        self._seac(asb, adx, ady, int(bchar), int(achar))
                        return True
                    st.clear()
                elif b2 == 7:                    # sbw
                    if len(st) >= 4:
                        self.x, self.y = st[0], st[1]
                        self.sbx = st[0]
                    st.clear()
                elif b2 == 16:                   # callothersubr
                    if len(st) >= 2:
                        othersubr = int(st.pop())
                        n = int(st.pop())
                        args = st[-n:] if n else []
                        del st[len(st) - n:]
                        if othersubr == 1:       # flex start
                            self.in_flex = True
                        elif othersubr == 0:     # flex end
                            self.in_flex = False
                            self.ps_stack = [self.y, self.x]
                        elif othersubr == 3:     # hint replacement
                            self.ps_stack = [3]
                        else:
                            self.ps_stack = list(reversed(args))
                elif b2 == 17:                   # pop
                    st.append(self.ps_stack.pop() if self.ps_stack
                              else 0.0)
                elif b2 == 33:                   # setcurrentpoint
                    if len(st) >= 2:
                        self.x, self.y = st[-2], st[-1]
                    st.clear()
                else:                            # dotsection, stem3...
                    st.clear()
            else:
                st.clear()
        return False

    def _rel_curve(self, dx1, dy1, dx2, dy2, dx3, dy3):
        x1, y1 = self.x + dx1, self.y + dy1
        x2, y2 = x1 + dx2, y1 + dy2
        x3, y3 = x2 + dx3, y2 + dy3
        self.cur.extend(_flatten_cubic(
            (self.x, self.y), (x1, y1), (x2, y2), (x3, y3)))
        self.x, self.y = x3, y3

    def _seac(self, asb, adx, ady, bchar: int, achar: int):
        """Standard accented char: draw base + accent glyphs."""
        bname = STANDARD_ENCODING.get(bchar)
        aname = STANDARD_ENCODING.get(achar)
        if bname:
            self.contours.extend(self.font.contours_for_name(bname))
        if aname:
            off = np.array([self.sbx - asb + adx, ady], np.float64)
            for c in self.font.contours_for_name(aname):
                self.contours.append(c + off)


# =========================== facade ===========================

class EmbeddedGlyphs:
    """Uniform glyph-outline lookup over the three program formats.

    ``contours(code, uni, names)`` returns flattened contours in font
    units (scale by ``1/units_per_em``), or None when the glyph can't
    be resolved (caller falls back to the Hershey face)."""

    def __init__(self, kind: str, font, *, cid: bool = False,
                 cid_to_gid: Optional[bytes] = None):
        self.kind = kind                        # "tt" | "cff" | "t1"
        self.font = font
        self.cid = cid
        self.cid_to_gid = cid_to_gid
        self.units_per_em = float(font.units_per_em)

    def _gid_for_cid(self, cid: int) -> int:
        m = self.cid_to_gid
        if m is not None:
            i = 2 * cid
            return (m[i] << 8) | m[i + 1] if i + 1 < len(m) else 0
        if self.kind == "cff":
            return self.font.gid_for_cid(cid)
        return cid

    def contours(self, code: int, uni: str,
                 name: Optional[str] = None) -> Optional[Contours]:
        f = self.font
        if self.kind == "tt":
            if self.cid:
                gid = self._gid_for_cid(code)
            else:
                gid = f.gid_for_unicode(uni) if uni else 0
                if not gid and name:
                    gid = f.gid_for_unicode(NAME_TO_UNICODE.get(name, ""))
                if not gid:
                    gid = f._cmap.get(code, 0) or f._cmap.get(
                        0xF000 | code, 0)
            if not gid or gid >= f.num_glyphs:
                return None
            return f.contours_for_gid(gid)
        if self.kind == "cff":
            if self.cid:
                gid = self._gid_for_cid(code)
            else:
                gid = f.gid_for_name(name) if name else 0
                if not gid:
                    gid = f.code_to_gid.get(code, 0)
                if not gid and uni:
                    sn = STANDARD_ENCODING.get(ord(uni[0]))
                    gid = f.gid_for_name(sn) if sn else 0
            if not gid or gid >= f.nglyphs:
                return None
            return f.contours_for_gid(gid)
        # type1. A name that RESOLVES to an empty charstring (a space)
        # returns [] — "resolved empty", distinct from None
        # ("unresolvable", which the renderer ink-boxes).
        n = name or f.name_for_code(code) \
            or (STANDARD_ENCODING.get(ord(uni[0])) if uni else None)
        if not n or n not in f.charstrings:
            return None
        return f.contours_for_name(n)


def load_font_program(kind: str, data: bytes, *, cid: bool = False,
                      cid_to_gid: Optional[bytes] = None
                      ) -> EmbeddedGlyphs:
    """Parse a FontFile/FontFile2/FontFile3 stream into an
    :class:`EmbeddedGlyphs`. ``kind``: "FontFile", "FontFile2",
    "FontFile3". Raises on malformed programs (caller catches)."""
    if kind == "FontFile2":
        try:
            return EmbeddedGlyphs("tt", TrueTypeGlyphs(data), cid=cid,
                                  cid_to_gid=cid_to_gid)
        except Exception:
            # some producers put CFF-flavored OpenType in FontFile2
            return EmbeddedGlyphs("cff", CFFGlyphs(data), cid=cid,
                                  cid_to_gid=cid_to_gid)
    if kind == "FontFile3":
        return EmbeddedGlyphs("cff", CFFGlyphs(data), cid=cid,
                              cid_to_gid=cid_to_gid)
    if kind == "FontFile":
        return EmbeddedGlyphs("t1", Type1Glyphs(data))
    raise ValueError(f"unknown font program kind {kind!r}")
