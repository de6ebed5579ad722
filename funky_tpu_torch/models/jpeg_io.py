"""Pure-Python/numpy JPEG decoder (numpy copy of funky_tpu/models/jpeg_io.py;
the decode ladder here is this decoder, then PIL: no native route).

The reference decodes whatever image format a glTF references through the
Rust `image` crate (gltf_loader.rs:100 `image::open`, :116
`load_from_memory`); its JPEG backend handles baseline and progressive
huffman streams. This module implements the identical algorithm to the
native decoder — baseline (SOF0) / extended (SOF1) / progressive (SOF2),
grayscale or YCbCr with sampling factors 1..4, restart markers, Adobe
APP14 transform tag, box chroma upsampling, float64 separable IDCT — so
the two paths agree to IDCT rounding (tests assert it).

Entropy decoding is a Python bit loop (fine for the fallback role: a
512^2 texture decodes in ~1 s); everything after the huffman pass is
vectorized numpy (dequant + IDCT via einsum over all blocks at once).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np

ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63],
    np.int32)


def is_jpeg(data: bytes) -> bool:
    return len(data) >= 3 and data[:3] == b"\xff\xd8\xff"


class _Bits:
    """Entropy-coded bit reader: 0xFF00 unstuffing, zero-pad at markers."""

    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0
        self.buf = 0
        self.cnt = 0

    def reset(self, pos: int):
        self.pos = pos
        self.buf = 0
        self.cnt = 0

    def bit(self) -> int:
        if self.cnt == 0:
            if self.pos >= len(self.data):
                return 0
            b = self.data[self.pos]
            self.pos += 1
            if b == 0xFF:
                nxt = self.data[self.pos] if self.pos < len(self.data) else 0xD9
                if nxt == 0x00:
                    self.pos += 1
                else:
                    # marker: rewind and pad with zero bits (T.81)
                    self.pos -= 1
                    self.buf = 0
                    self.cnt = 1
                    return 0
            self.buf = b
            self.cnt = 8
        self.cnt -= 1
        return (self.buf >> self.cnt) & 1

    def bits(self, n: int) -> int:
        v = 0
        for _ in range(n):
            v = (v << 1) | self.bit()
        return v


@dataclass
class _Huff:
    mincode: list = field(default_factory=lambda: [0] * 17)
    maxcode: list = field(default_factory=lambda: [-1] * 17)
    valptr: list = field(default_factory=lambda: [0] * 17)
    vals: bytes = b""

    def decode(self, br: _Bits) -> int:
        code = 0
        for length in range(1, 17):
            code = (code << 1) | br.bit()
            if code <= self.maxcode[length]:
                return self.vals[self.valptr[length] + code
                                 - self.mincode[length]]
        raise ValueError("bad huffman code")


def _extend(v: int, t: int) -> int:
    return v - (1 << t) + 1 if t and v < (1 << (t - 1)) else v


@dataclass
class _Comp:
    cid: int
    h: int
    v: int
    tq: int
    td: int = 0
    ta: int = 0
    pred: int = 0
    bw: int = 0
    bh: int = 0
    bw_used: int = 0
    bh_used: int = 0
    coef: np.ndarray | None = None  # (bh, bw, 64) int32, natural order


class _Decoder:
    def __init__(self, data: bytes):
        self.data = data
        self.qt = np.zeros((4, 64), np.int32)
        self.hdc: dict[int, _Huff] = {}
        self.hac: dict[int, _Huff] = {}
        self.comps: list[_Comp] = []
        self.width = self.height = 0
        self.progressive = False
        self.hmax = self.vmax = 1
        self.mcux = self.mcuy = 0
        self.restart_interval = 0
        self.adobe_transform = -1
        self.eobrun = 0

    # -- marker-level parse --

    def parse(self):
        d = self.data
        if not is_jpeg(d):
            raise ValueError("not a JPEG")
        pos = 2
        while pos + 4 <= len(d):
            if d[pos] != 0xFF:
                pos += 1
                continue
            if d[pos + 1] == 0xFF:
                pos += 1
                continue
            marker = d[pos + 1]
            pos += 2
            if marker == 0x01 or 0xD0 <= marker <= 0xD7:
                continue
            if marker == 0xD9:
                break
            seg_len = (d[pos] << 8) | d[pos + 1]
            body = pos + 2
            seg_end = pos + seg_len
            if seg_len < 2 or seg_end > len(d):
                raise ValueError("truncated segment")
            if marker in (0xC0, 0xC1, 0xC2):
                self._sof(d[body:seg_end], marker == 0xC2)
            elif marker in (0xC3, 0xC5, 0xC6, 0xC7, 0xC9, 0xCA, 0xCB,
                            0xCD, 0xCE, 0xCF):
                raise ValueError("unsupported JPEG coding process")
            elif marker == 0xC4:
                self._dht(d[body:seg_end])
            elif marker == 0xDB:
                self._dqt(d[body:seg_end])
            elif marker == 0xDD:
                self.restart_interval = (d[body] << 8) | d[body + 1]
            elif marker == 0xEE and seg_len >= 14 and \
                    d[body:body + 5] == b"Adobe":
                self.adobe_transform = d[body + 11]
            elif marker == 0xDA:
                pos = self._sos(body, seg_end)
                continue
            pos = seg_end
        if not self.comps:
            raise ValueError("no SOF")

    def _dqt(self, seg: bytes):
        i = 0
        while i < len(seg):
            pq, tq = seg[i] >> 4, seg[i] & 15
            i += 1
            if pq:
                vals = np.frombuffer(seg[i:i + 128], ">u2").astype(np.int32)
                i += 128
            else:
                vals = np.frombuffer(seg[i:i + 64], np.uint8).astype(np.int32)
                i += 64
            self.qt[tq, ZIGZAG] = vals

    def _dht(self, seg: bytes):
        i = 0
        while i < len(seg):
            tc, th = seg[i] >> 4, seg[i] & 15
            counts = list(seg[i + 1:i + 17])
            total = sum(counts)
            h = _Huff(vals=bytes(seg[i + 17:i + 17 + total]))
            code = k = 0
            for length in range(1, 17):
                h.valptr[length] = k
                h.mincode[length] = code
                code += counts[length - 1]
                k += counts[length - 1]
                h.maxcode[length] = code - 1 if counts[length - 1] else -1
                code <<= 1
            (self.hac if tc else self.hdc)[th] = h
            i += 17 + total

    def _sof(self, seg: bytes, progressive: bool):
        self.progressive = progressive
        self.height = (seg[1] << 8) | seg[2]
        self.width = (seg[3] << 8) | seg[4]
        n = seg[5]
        if n not in (1, 3):
            raise ValueError(f"unsupported component count {n}")
        for i in range(n):
            cid, hv, tq = seg[6 + 3 * i:9 + 3 * i]
            self.comps.append(_Comp(cid, hv >> 4, hv & 15, tq))
        self.hmax = max(c.h for c in self.comps)
        self.vmax = max(c.v for c in self.comps)
        self.mcux = -(-self.width // (8 * self.hmax))
        self.mcuy = -(-self.height // (8 * self.vmax))
        for c in self.comps:
            c.bw = self.mcux * c.h
            c.bh = self.mcuy * c.v
            c.bw_used = -(-(self.width * c.h) // (8 * self.hmax))
            c.bh_used = -(-(self.height * c.v) // (8 * self.vmax))
            c.coef = np.zeros((c.bh, c.bw, 64), np.int32)

    # -- scan decode --

    def _sos(self, body: int, seg_end: int) -> int:
        d = self.data
        ns = d[body]
        sc = []
        for j in range(ns):
            cid, tdta = d[body + 1 + 2 * j], d[body + 2 + 2 * j]
            c = next(c for c in self.comps if c.cid == cid)
            c.td, c.ta = tdta >> 4, tdta & 15
            sc.append(c)
        ss, se, ahal = d[body + 1 + 2 * ns:body + 4 + 2 * ns]
        ah, al = ahal >> 4, ahal & 15
        if not self.progressive:
            ss, se, ah, al = 0, 63, 0, 0
        for c in sc:
            c.pred = 0
        self.eobrun = 0
        br = _Bits(d)
        br.reset(seg_end)

        if ns == 1:
            c = sc[0]
            n_units = c.bh_used * c.bw_used
        else:
            n_units = self.mcuy * self.mcux
        todo = self.restart_interval
        for u in range(n_units):
            if ns == 1:
                c = sc[0]
                by, bx = divmod(u, c.bw_used)
                self._unit(br, c, by, bx, ss, se, ah, al)
            else:
                my, mx = divmod(u, self.mcux)
                for c in sc:
                    for v in range(c.v):
                        for hh in range(c.h):
                            self._unit(br, c, my * c.v + v, mx * c.h + hh,
                                       ss, se, ah, al)
            if self.restart_interval:
                todo -= 1
                if todo == 0 and u != n_units - 1:
                    # byte-align + RSTn + reset predictors
                    p = br.pos
                    if not (p + 2 <= len(d) and d[p] == 0xFF
                            and 0xD0 <= d[p + 1] <= 0xD7):
                        raise ValueError("missing restart marker")
                    br.reset(p + 2)
                    for cc in sc:
                        cc.pred = 0
                    self.eobrun = 0
                    todo = self.restart_interval
        return br.pos

    def _unit(self, br, c, by, bx, ss, se, ah, al):
        out = c.coef[by, bx]
        if not self.progressive:
            self._block_baseline(br, c, out)
        elif ss == 0:
            if ah == 0:
                t = self.hdc[c.td].decode(br)
                c.pred += _extend(br.bits(t), t)
                out[0] = c.pred << al
            elif br.bit():
                out[0] |= 1 << al
        elif ah == 0:
            self._block_ac_first(br, c, out, ss, se, al)
        else:
            self._block_ac_refine(br, c, out, ss, se, al)

    def _block_baseline(self, br, c, out):
        t = self.hdc[c.td].decode(br)
        c.pred += _extend(br.bits(t), t)
        out[0] = c.pred
        ac = self.hac[c.ta]
        k = 1
        while k < 64:
            rs = ac.decode(br)
            r, s = rs >> 4, rs & 15
            if s == 0:
                if r != 15:
                    break
                k += 16
                continue
            k += r
            if k > 63:
                raise ValueError("AC index overflow")
            out[ZIGZAG[k]] = _extend(br.bits(s), s)
            k += 1

    def _block_ac_first(self, br, c, out, ss, se, al):
        if self.eobrun > 0:
            self.eobrun -= 1
            return
        ac = self.hac[c.ta]
        k = ss
        while k <= se:
            rs = ac.decode(br)
            r, s = rs >> 4, rs & 15
            if s == 0:
                if r != 15:
                    self.eobrun = (1 << r) - 1
                    if r:
                        self.eobrun += br.bits(r)
                    break
                k += 16
                continue
            k += r
            if k > 63:
                raise ValueError("AC index overflow")
            out[ZIGZAG[k]] = _extend(br.bits(s), s) << al
            k += 1

    def _block_ac_refine(self, br, c, out, ss, se, al):
        p1, m1 = 1 << al, -(1 << al)

        def correct(k):
            if br.bit() and not (out[ZIGZAG[k]] & p1):
                out[ZIGZAG[k]] += p1 if out[ZIGZAG[k]] >= 0 else m1

        ac = self.hac[c.ta]
        k = ss
        if self.eobrun == 0:
            while k <= se:
                rs = ac.decode(br)
                r, s = rs >> 4, rs & 15
                newval = 0
                if s == 0:
                    if r != 15:
                        self.eobrun = 1 << r
                        if r:
                            self.eobrun += br.bits(r)
                        break
                else:  # s must be 1 in a refinement scan
                    newval = p1 if br.bit() else m1
                while k <= se:
                    if out[ZIGZAG[k]] != 0:
                        correct(k)
                    else:
                        if r == 0:
                            break
                        r -= 1
                    k += 1
                if s and k <= se:
                    out[ZIGZAG[k]] = newval
                k += 1
        if self.eobrun > 0:
            while k <= se:
                if out[ZIGZAG[k]] != 0:
                    correct(k)
                k += 1
            self.eobrun -= 1

    # -- reconstruction (vectorized) --

    def reconstruct(self) -> np.ndarray:
        # IDCT basis: ctab[u, x] = cu/2 * cos((2x+1) u pi / 16)
        u = np.arange(8)[:, None]
        x = np.arange(8)[None, :]
        ctab = 0.5 * np.cos((2 * x + 1) * u * math.pi / 16.0)
        ctab[0] = math.sqrt(0.125)

        planes = []
        for c in self.comps:
            blocks = (c.coef.astype(np.float64).reshape(c.bh, c.bw, 8, 8)
                      * self.qt[c.tq].astype(np.float64).reshape(8, 8))
            # samples[y, x] = sum_uv ctab[u, y] ctab[v, x] coef[u, v]
            spatial = np.einsum("uy,vx,bcuv->bcyx", ctab, ctab, blocks)
            samp = np.rint(spatial) + 128.0
            samp = np.clip(samp, 0, 255).astype(np.uint8)
            plane = samp.transpose(0, 2, 1, 3).reshape(c.bh * 8, c.bw * 8)
            # box upsample to full res + crop
            plane = np.repeat(np.repeat(plane, self.vmax // c.v, axis=0),
                              self.hmax // c.h, axis=1)
            planes.append(plane[:self.height, :self.width])
        if len(planes) == 1:
            y = planes[0]
            rgb = np.repeat(y[..., None], 3, axis=-1)
        else:
            ids = [c.cid for c in self.comps]
            rgb_ids = ids == [ord("R"), ord("G"), ord("B")]
            if rgb_ids or self.adobe_transform == 0:
                rgb = np.stack(planes, axis=-1)
            else:
                yv = planes[0].astype(np.float64)
                cb = planes[1].astype(np.float64) - 128.0
                cr = planes[2].astype(np.float64) - 128.0
                r = yv + 1.402 * cr
                g = yv - 0.344136 * cb - 0.714136 * cr
                b = yv + 1.772 * cb
                rgb = np.clip(np.rint(np.stack([r, g, b], axis=-1)),
                              0, 255).astype(np.uint8)
        a = np.full((self.height, self.width, 1), 255, np.uint8)
        return np.concatenate([rgb, a], axis=-1)


def decode_jpeg_pure(data: bytes) -> np.ndarray:
    """Decode JPEG bytes to (H, W, 4) uint8 RGBA (numpy fallback path)."""
    dec = _Decoder(data)
    dec.parse()
    return dec.reconstruct()


def decode_jpeg(data: bytes) -> np.ndarray:
    """Decode JPEG bytes to (H, W, 4) uint8 RGBA.

    The JAX package prefers native/fr_jpeg.cpp, then PIL. This copy has no
    native route; the numpy decoder above takes its place because it decodes
    bit-identically to it, while PIL's libjpeg differs by up to 91 levels on
    tests/assets/quad_tex_420p.jpg (4:2:0 chroma). PIL stays the fallback
    for streams the numpy decoder does not support.
    """
    try:
        return decode_jpeg_pure(data)
    except ValueError as err:
        try:
            from PIL import Image  # noqa: PLC0415
        except ImportError:
            raise err from None
        import io  # noqa: PLC0415

        img = Image.open(io.BytesIO(data)).convert("RGBA")
        return np.asarray(img, np.uint8)


def decode_image(data: bytes) -> np.ndarray:
    """Sniff + decode PNG or JPEG bytes to (H, W, 4) RGBA8 — the behavior
    of the reference's image::load_from_memory (gltf_loader.rs:116)."""
    from .png_io import decode_png  # noqa: PLC0415

    if is_jpeg(data):
        return decode_jpeg(data)
    return decode_png(data)
