"""Image files read with the standard library and numpy alone, as PIL
reads them: the LFW reader's decode and resize (``datasets/lfw.py``).

The card's machine has no imaging package, so the port decodes its
image trees itself, bit for bit what PIL (Pillow over libjpeg-turbo)
gives for the same file:

- **JPEG**: baseline and extended Huffman (SOF0 / SOF1), 8-bit,
  grayscale or YCbCr (RGB under an Adobe transform of 0), any integral
  sampling, restart intervals, interleaved or not. libjpeg's decode,
  step for step: the integer ``jpeg_idct_islow`` with its range-limit
  table, the "fancy" triangle upsampling of 2:1 chroma (``jdsample.c``:
  h2v1, h1v2, h2v2; box replication otherwise) with the edge rows
  duplicated as ``jdmainct.c`` does, and ``jdcolor.c``'s fixed-point
  YCbCr to RGB. Progressive, arithmetic-coded, 12-bit, CMYK and
  lossless files raise ``ValueError``.
- **PNG**: every colour type at 8 bits (gray and palette also at 1, 2
  and 4), the five row filters; interlaced and 16-bit files raise.
- **PPM / PGM** (binary, maxval 255) and **BMP** (uncompressed 24- and
  32-bit).

``convert`` is PIL's ``Image.convert("RGB" | "L")`` (ITU-R 601-2 luma in
16-bit fixed point) and ``resize`` its default ``Image.resize`` (bicubic,
a = -0.5, coefficients in 22-bit fixed point, horizontal pass first).
Images are ``(mode, uint8 array)`` pairs: mode ``"L"`` [h, w], ``"LA"``
[h, w, 2], ``"RGB"`` [h, w, 3], ``"RGBA"`` [h, w, 4] or ``"P"`` [h, w]
with its palette [256, 3].
"""

from __future__ import annotations

import struct
import zlib
from typing import Optional, Tuple

import numpy as np

Image = Tuple[str, np.ndarray, Optional[np.ndarray]]  # mode, pixels, palette


def read(path: str) -> Image:
    """The decoded image of the file at ``path``, by its signature."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:2] == b"\xff\xd8":
        return decode_jpeg(data)
    if data[:8] == b"\x89PNG\r\n\x1a\n":
        return decode_png(data)
    if data[:2] in (b"P5", b"P6"):
        return decode_pnm(data)
    if data[:2] == b"BM":
        return decode_bmp(data)
    raise ValueError(f"{path}: not a JPEG, PNG, PPM or BMP file")


# --- conversion and resizing (PIL's Convert.c and Resample.c) ---------------


def _luma(rgb: np.ndarray) -> np.ndarray:
    r, g, b = (rgb[..., i].astype(np.int64) for i in range(3))
    return ((r * 19595 + g * 38470 + b * 7471 + 0x8000) >> 16).astype(
        np.uint8)


def convert(img: Image, mode: str) -> np.ndarray:
    """``img`` as PIL's ``convert(mode)`` gives it: ``"RGB"`` [h, w, 3] or
    ``"L"`` [h, w] uint8. Alpha is dropped, not composited."""
    src, a, palette = img
    if src == "P":
        a = palette[a]
        src = "RGB"
    if mode == "RGB":
        if src in ("L", "LA"):
            g = a if src == "L" else a[..., 0]
            return np.repeat(g[..., None], 3, axis=2)
        return np.ascontiguousarray(a[..., :3])
    if mode == "L":
        if src in ("L", "LA"):
            return a if src == "L" else np.ascontiguousarray(a[..., 0])
        return _luma(a)
    raise ValueError(f"unsupported mode {mode!r}")


_PRECISION_BITS = 32 - 8 - 2


def _bicubic(x: float) -> float:
    a = -0.5
    if x < 0.0:
        x = -x
    if x < 1.0:
        return ((a + 2.0) * x - (a + 3.0)) * x * x + 1
    if x < 2.0:
        return (((x - 5) * x + 8) * x - 4) * a
    return 0.0


def _coeffs(in_size: int, out_size: int):
    """PIL's ``precompute_coeffs`` and ``normalize_coeffs_8bpc`` for the
    bicubic filter over the whole axis: per output index its first input
    index and its fixed-point weights."""
    scale = filterscale = in_size / out_size
    if filterscale < 1.0:
        filterscale = 1.0
    support = 2.0 * filterscale
    out = []
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        ss = 1.0 / filterscale
        xmin = int(center - support + 0.5)
        if xmin < 0:
            xmin = 0
        xmax = int(center + support + 0.5)
        if xmax > in_size:
            xmax = in_size
        xmax -= xmin
        k = [_bicubic((x + xmin - center + 0.5) * ss) for x in range(xmax)]
        ww = 0.0
        for w in k:
            ww += w
        if ww != 0.0:
            k = [w / ww for w in k]
        fixed = [int(-0.5 + w * (1 << _PRECISION_BITS)) if w < 0
                 else int(0.5 + w * (1 << _PRECISION_BITS)) for w in k]
        out.append((xmin, np.asarray(fixed, np.int64)))
    return out


def _resample_axis(a: np.ndarray, out_size: int, axis: int) -> np.ndarray:
    a = np.moveaxis(a, axis, 0).astype(np.int64)
    rows = []
    for start, k in _coeffs(a.shape[0], out_size):
        ss = np.tensordot(k, a[start:start + len(k)], axes=(0, 0))
        ss = ss + (1 << (_PRECISION_BITS - 1))
        rows.append(np.clip(ss >> _PRECISION_BITS, 0, 255))
    return np.moveaxis(np.stack(rows).astype(np.uint8), 0, axis)


def resize(a: np.ndarray, width: int, height: int) -> np.ndarray:
    """``a`` ([h, w] or [h, w, c] uint8) resized as PIL's default
    ``Image.resize((width, height))`` resizes an "L" or "RGB" image."""
    h, w = a.shape[:2]
    if (w, h) == (width, height):
        return a.copy()
    if w != width:
        a = _resample_axis(a, width, 1)
    if h != height:
        a = _resample_axis(a, height, 0)
    return a


# --- JPEG (libjpeg's baseline decode) ---------------------------------------

_ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63])
_NATURAL = [int(v) for v in _ZIGZAG]  # zigzag position -> natural index


def _huffman_lut(counts, symbols):
    """A 65,536-entry table: the next 16 bits -> (code length << 8) |
    symbol (0 where no code matches)."""
    lut = [0] * 65536
    code = 0
    i = 0
    for length in range(1, 17):
        for _ in range(counts[length - 1]):
            span = 1 << (16 - length)
            lut[code * span:(code + 1) * span] = [(length << 8)
                                                  | symbols[i]] * span
            code += 1
            i += 1
        code <<= 1
    return lut


def _unstuff(seg: bytes) -> bytes:
    return seg.replace(b"\xff\x00", b"\xff")


def _decode_interval(data: bytes, units, coefs, mcus):
    """Huffman-decode ``mcus`` MCUs of one restart interval from
    ``data`` (unstuffed) into ``coefs`` (per component [rows, cols, 64]
    natural order, not dequantized): ``units`` lists, for one MCU, each
    block's (component index, dc lut, ac lut) and its block offset."""
    n = len(data)
    acc = 0
    nbits = 0
    pos = 0
    pred = [0] * len(coefs)
    natural = _NATURAL
    for at in mcus:
        for ci, dc_lut, ac_lut, by, bx in units(at):
            block = coefs[ci][by, bx]
            # DC
            while nbits < 16:
                acc = (acc << 8) | (data[pos] if pos < n else 0)
                pos += 1
                nbits += 8
            e = dc_lut[(acc >> (nbits - 16)) & 0xFFFF]
            if e == 0:
                raise ValueError("JPEG: bad Huffman code")
            nbits -= e >> 8
            s = e & 0xFF
            diff = 0
            if s:
                while nbits < s:
                    acc = (acc << 8) | (data[pos] if pos < n else 0)
                    pos += 1
                    nbits += 8
                diff = (acc >> (nbits - s)) & ((1 << s) - 1)
                nbits -= s
                if diff < (1 << (s - 1)):
                    diff -= (1 << s) - 1
            pred[ci] += diff
            block[0] = pred[ci]
            # AC
            k = 1
            while k < 64:
                while nbits < 16:
                    acc = (acc << 8) | (data[pos] if pos < n else 0)
                    pos += 1
                    nbits += 8
                e = ac_lut[(acc >> (nbits - 16)) & 0xFFFF]
                if e == 0:
                    raise ValueError("JPEG: bad Huffman code")
                nbits -= e >> 8
                rs = e & 0xFF
                r, s = rs >> 4, rs & 15
                if s:
                    k += r
                    while nbits < s:
                        acc = (acc << 8) | (data[pos] if pos < n else 0)
                        pos += 1
                        nbits += 8
                    v = (acc >> (nbits - s)) & ((1 << s) - 1)
                    nbits -= s
                    if v < (1 << (s - 1)):
                        v -= (1 << s) - 1
                    if k > 63:
                        raise ValueError("JPEG: coefficient past the block")
                    block[natural[k]] = v
                    k += 1
                elif r == 15:
                    k += 16
                else:
                    break
            acc &= (1 << nbits) - 1


# jidctint.c's constants (CONST_BITS 13)
_C = dict(f0298=2446, f0390=3196, f0541=4433, f0765=6270, f0899=7373,
          f1175=9633, f1501=12299, f1847=15137, f1961=16069, f2053=16819,
          f2562=20995, f3072=25172)


def _idct_1d(x, axis, shift):
    """One pass of ``jpeg_idct_islow`` along ``axis`` of int64 ``x``
    (its 8 entries the inputs in order), each output descaled by
    ``shift`` bits."""
    c = _C
    g = [np.take(x, i, axis=axis) for i in range(8)]
    z2, z3 = g[2], g[6]
    z1 = (z2 + z3) * c["f0541"]
    tmp2 = z1 + z3 * -c["f1847"]
    tmp3 = z1 + z2 * c["f0765"]
    tmp0 = (g[0] + g[4]) << 13
    tmp1 = (g[0] - g[4]) << 13
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    tmp0, tmp1, tmp2, tmp3 = g[7], g[5], g[3], g[1]
    z1, z2, z3, z4 = tmp0 + tmp3, tmp1 + tmp2, tmp0 + tmp2, tmp1 + tmp3
    z5 = (z3 + z4) * c["f1175"]
    tmp0 = tmp0 * c["f0298"]
    tmp1 = tmp1 * c["f2053"]
    tmp2 = tmp2 * c["f3072"]
    tmp3 = tmp3 * c["f1501"]
    z1 = z1 * -c["f0899"]
    z2 = z2 * -c["f2562"]
    z3 = z3 * -c["f1961"] + z5
    z4 = z4 * -c["f0390"] + z5
    tmp0 += z1 + z3
    tmp1 += z2 + z4
    tmp2 += z2 + z3
    tmp3 += z1 + z4
    half = 1 << (shift - 1)
    out = [tmp10 + tmp3, tmp11 + tmp2, tmp12 + tmp1, tmp13 + tmp0,
           tmp13 - tmp0, tmp12 - tmp1, tmp11 - tmp2, tmp10 - tmp3]
    return np.stack([(o + half) >> shift for o in out], axis=axis)


def _idct_range_limit() -> np.ndarray:
    """libjpeg's post-IDCT range-limit table, indexed by (x & 1023)."""
    t = np.zeros(1024, np.uint8)
    t[:128] = np.arange(128, 256)
    t[128:512] = 255
    t[896:] = np.arange(128)
    return t


_RANGE_LIMIT = _idct_range_limit()


def _idct_islow(blocks: np.ndarray, qt: np.ndarray) -> np.ndarray:
    """[..., 64] coefficients (natural order) -> [..., 8, 8] samples."""
    x = (blocks.astype(np.int64) * qt.astype(np.int64)).reshape(
        blocks.shape[:-1] + (8, 8))
    ws = _idct_1d(x, -2, 13 - 2)      # columns (pass 1), PASS1_BITS 2
    out = _idct_1d(ws, -1, 13 + 2 + 3)  # rows (pass 2)
    return _RANGE_LIMIT[out & 1023]


def _fancy_h2(a: np.ndarray, vert: bool) -> np.ndarray:
    """2:1 horizontal upsampling of a plane: ``h2v1_fancy_upsample`` on
    samples, or ``h2v2_fancy_upsample``'s column pass on 3*near + far
    sums (``vert``)."""
    a = a.astype(np.int64)
    prev = np.concatenate([a[:, :1], a[:, :-1]], axis=1)
    nxt = np.concatenate([a[:, 1:], a[:, -1:]], axis=1)
    out = np.empty((a.shape[0], 2 * a.shape[1]), np.int64)
    if vert:
        out[:, 0::2] = (a * 3 + prev + 8) >> 4
        out[:, 1::2] = (a * 3 + nxt + 7) >> 4
        out[:, 0] = (a[:, 0] * 4 + 8) >> 4
        out[:, -1] = (a[:, -1] * 4 + 7) >> 4
    else:
        out[:, 0::2] = (a * 3 + prev + 1) >> 2
        out[:, 1::2] = (a * 3 + nxt + 2) >> 2
        out[:, 0] = a[:, 0]
        out[:, -1] = a[:, -1]
    return out


def _upsample(p: np.ndarray, hx: int, vx: int) -> np.ndarray:
    """``jdsample.c``'s upsampling of a downsampled plane by (hx, vx),
    the plane's rows and columns past its edge duplicating the edge."""
    h, w = p.shape
    if hx == 1 and vx == 1:
        return p
    if vx == 2 and hx in (1, 2) and (hx == 1 or w > 2):
        a = p.astype(np.int64)
        above = np.concatenate([a[:1], a[:-1]], axis=0)
        below = np.concatenate([a[1:], a[-1:]], axis=0)
        rows = np.empty((2 * h, w), np.int64)
        rows[0::2] = a * 3 + above
        rows[1::2] = a * 3 + below
        if hx == 2:
            return _fancy_h2(rows, vert=True).astype(np.uint8)
        out = rows.copy()
        out[0::2] = (rows[0::2] + 1) >> 2
        out[1::2] = (rows[1::2] + 2) >> 2
        return out.astype(np.uint8)
    if vx == 1 and hx == 2 and w > 2:
        return _fancy_h2(p, vert=False).astype(np.uint8)
    return np.repeat(np.repeat(p, vx, axis=0), hx, axis=1)


def _ycc_to_rgb(y, cb, cr) -> np.ndarray:
    """``jdcolor.c``'s ``ycc_rgb_convert`` (16-bit fixed point)."""
    one_half = 1 << 15
    x = np.arange(256, dtype=np.int64) - 128
    cr_r = (91881 * x + one_half) >> 16
    cb_b = (116130 * x + one_half) >> 16
    cr_g = -46802 * x
    cb_g = -22554 * x + one_half
    y = y.astype(np.int64)
    r = y + cr_r[cr]
    g = y + ((cb_g[cb] + cr_g[cr]) >> 16)
    b = y + cb_b[cb]
    return np.clip(np.stack([r, g, b], axis=-1), 0, 255).astype(np.uint8)


def decode_jpeg(data: bytes) -> Image:
    qts = {}
    dc_luts, ac_luts = {}, {}
    frame = None
    coefs = None
    restart = 0
    adobe_transform = None
    pos = 2
    n = len(data)
    while pos < n:
        if data[pos] != 0xFF:
            raise ValueError("JPEG: expected a marker")
        while pos < n and data[pos] == 0xFF:
            pos += 1
        marker = data[pos]
        pos += 1
        if marker == 0xD9:  # EOI
            break
        if 0xD0 <= marker <= 0xD7 or marker == 0x01:
            continue
        (length,) = struct.unpack(">H", data[pos:pos + 2])
        seg = data[pos + 2:pos + length]
        pos += length
        if marker == 0xDB:  # DQT
            i = 0
            while i < len(seg):
                pq, tq = seg[i] >> 4, seg[i] & 15
                i += 1
                if pq:
                    vals = struct.unpack(">64H", seg[i:i + 128])
                    i += 128
                else:
                    vals = list(seg[i:i + 64])
                    i += 64
                q = np.zeros(64, np.int64)
                q[_ZIGZAG] = np.asarray(vals, np.int64)
                qts[tq] = q
        elif marker == 0xC4:  # DHT
            i = 0
            while i < len(seg):
                tc, th = seg[i] >> 4, seg[i] & 15
                counts = seg[i + 1:i + 17]
                total = sum(counts)
                symbols = seg[i + 17:i + 17 + total]
                i += 17 + total
                (ac_luts if tc else dc_luts)[th] = _huffman_lut(counts,
                                                                symbols)
        elif marker == 0xDD:  # DRI
            (restart,) = struct.unpack(">H", seg[:2])
        elif marker == 0xEE and seg[:5] == b"Adobe" and len(seg) >= 12:
            adobe_transform = seg[11]
        elif marker in (0xC0, 0xC1):
            precision, height, width, nf = struct.unpack(">BHHB", seg[:6])
            if precision != 8:
                raise ValueError(f"JPEG: {precision}-bit samples")
            if height == 0:
                raise ValueError("JPEG: height given by a DNL marker")
            comps = []
            for c in range(nf):
                cid, hv, tq = seg[6 + 3 * c:9 + 3 * c]
                comps.append({"id": cid, "h": hv >> 4, "v": hv & 15,
                              "tq": tq})
            hmax = max(c["h"] for c in comps)
            vmax = max(c["v"] for c in comps)
            mcux = -(-width // (8 * hmax))
            mcuy = -(-height // (8 * vmax))
            for c in comps:
                c["bw"] = mcux * c["h"]
                c["bh"] = mcuy * c["v"]
                c["dw"] = -(-width * c["h"] // hmax)
                c["dh"] = -(-height * c["v"] // vmax)
            frame = (width, height, comps, hmax, vmax, mcux, mcuy)
            coefs = [np.zeros((c["bh"], c["bw"], 64), np.int64)
                     for c in comps]
        elif 0xC2 <= marker <= 0xCF and marker not in (0xC4, 0xC8, 0xCC):
            raise ValueError(f"JPEG: SOF{marker - 0xC0} (only baseline "
                             "and extended Huffman are read)")
        elif marker == 0xDA:  # SOS
            if frame is None:
                raise ValueError("JPEG: scan before the frame")
            pos = _scan(data, pos, seg, frame, coefs, dc_luts, ac_luts,
                        restart)
    if frame is None:
        raise ValueError("JPEG: no frame")
    width, height, comps, hmax, vmax, _, _ = frame
    planes = []
    for c, co in zip(comps, coefs):
        if c["tq"] not in qts:
            raise ValueError("JPEG: missing quantization table")
        s = _idct_islow(co, qts[c["tq"]])  # [bh, bw, 8, 8]
        s = s.transpose(0, 2, 1, 3).reshape(c["bh"] * 8, c["bw"] * 8)
        s = s[:c["dh"], :c["dw"]]
        if hmax % c["h"] or vmax % c["v"]:
            raise ValueError("JPEG: non-integral sampling")
        s = _upsample(s, hmax // c["h"], vmax // c["v"])
        planes.append(s[:height, :width])
    if len(planes) == 1:
        return "L", planes[0], None
    if len(planes) == 3:
        if adobe_transform == 0:
            return "RGB", np.stack(planes, axis=-1), None
        return "RGB", _ycc_to_rgb(*planes), None
    raise ValueError(f"JPEG: {len(planes)} components (CMYK is not read)")


def _scan(data, pos, seg, frame, coefs, dc_luts, ac_luts, restart):
    """Decode the scan whose header is ``seg`` and whose entropy-coded
    data starts at ``pos``; returns the position of the marker after
    it."""
    width, height, comps, hmax, vmax, mcux, mcuy = frame
    ns = seg[0]
    members = []
    for j in range(ns):
        cs, t = seg[1 + 2 * j], seg[2 + 2 * j]
        ci = next(i for i, c in enumerate(comps) if c["id"] == cs)
        members.append((ci, dc_luts[t >> 4], ac_luts[t & 15]))
    ss, se = seg[1 + 2 * ns], seg[2 + 2 * ns]
    if ss != 0 or se != 63:
        raise ValueError("JPEG: a spectral-selection scan")
    # the entropy-coded data up to the next marker that is not a restart
    end = pos
    n = len(data)
    while True:
        end = data.find(b"\xff", end)
        if end < 0 or end + 1 >= n:
            end = n
            break
        nxt = data[end + 1]
        if nxt == 0x00 or 0xD0 <= nxt <= 0xD7 or nxt == 0xFF:
            end += 2 if nxt != 0xFF else 1
            continue
        break
    body = data[pos:end]
    if ns == 1:
        ci, dc, ac = members[0]
        c = comps[ci]
        cols = -(-c["dw"] // 8)
        rows = -(-c["dh"] // 8)
        total = rows * cols

        def units(at):
            return ((ci, dc, ac, at // cols, at % cols),)
    else:
        total = mcux * mcuy
        layout = []
        for ci, dc, ac in members:
            c = comps[ci]
            for v in range(c["v"]):
                for h in range(c["h"]):
                    layout.append((ci, dc, ac, v, h))

        def units(at):
            my, mx = divmod(at, mcux)
            return [(ci, dc, ac, my * comps[ci]["v"] + v,
                     mx * comps[ci]["h"] + h)
                    for ci, dc, ac, v, h in layout]
    intervals = _split_restarts(body) if restart else [body]
    per = restart if restart else total
    for i, chunk in enumerate(intervals):
        lo = i * per
        if lo >= total:
            break
        _decode_interval(_unstuff(chunk), units, coefs,
                         range(lo, min(total, lo + per)))
    return end


def _split_restarts(body: bytes):
    out = []
    start = 0
    i = 0
    while True:
        i = body.find(b"\xff", i)
        if i < 0 or i + 1 >= len(body):
            break
        if 0xD0 <= body[i + 1] <= 0xD7:
            out.append(body[start:i])
            start = i + 2
            i += 2
        else:
            i += 2
    out.append(body[start:])
    return out


# --- PNG ---------------------------------------------------------------------

_PNG_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
_PNG_MODES = {0: "L", 2: "RGB", 3: "P", 4: "LA", 6: "RGBA"}


def _paeth_row(cur: bytearray, prev: bytes, bpp: int) -> None:
    for i in range(len(cur)):
        a = cur[i - bpp] if i >= bpp else 0
        b = prev[i]
        c = prev[i - bpp] if i >= bpp else 0
        p = a + b - c
        pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
        pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        cur[i] = (cur[i] + pred) & 0xFF


def _unfilter(raw: bytes, height: int, rowbytes: int, bpp: int) -> bytes:
    out = bytearray()
    prev = bytes(rowbytes)
    at = 0
    for _ in range(height):
        ftype = raw[at]
        cur = bytearray(raw[at + 1:at + 1 + rowbytes])
        at += 1 + rowbytes
        if ftype == 1:
            for i in range(bpp, rowbytes):
                cur[i] = (cur[i] + cur[i - bpp]) & 0xFF
        elif ftype == 2:
            cur = bytearray(((np.frombuffer(cur, np.uint8).astype(np.uint16)
                              + np.frombuffer(prev, np.uint8)) & 0xFF)
                            .astype(np.uint8).tobytes())
        elif ftype == 3:
            for i in range(rowbytes):
                left = cur[i - bpp] if i >= bpp else 0
                cur[i] = (cur[i] + ((left + prev[i]) >> 1)) & 0xFF
        elif ftype == 4:
            _paeth_row(cur, prev, bpp)
        elif ftype != 0:
            raise ValueError(f"PNG: filter type {ftype}")
        out += cur
        prev = bytes(cur)
    return bytes(out)


def decode_png(data: bytes) -> Image:
    pos = 8
    idat = []
    palette = None
    header = None
    while pos < len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.zeros((256, 3), np.uint8)
            pal = np.frombuffer(body, np.uint8).reshape(-1, 3)
            palette[:len(pal)] = pal
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError("PNG: no IHDR")
    width, height, depth, ctype, _, _, interlace = header
    if interlace:
        raise ValueError("PNG: interlaced files are not read")
    if depth == 16 or (depth < 8 and ctype not in (0, 3)):
        raise ValueError(f"PNG: {depth}-bit colour type {ctype}")
    channels = _PNG_CHANNELS[ctype]
    rowbytes = (width * channels * depth + 7) // 8
    bpp = max(1, channels * depth // 8)
    raw = _unfilter(zlib.decompress(b"".join(idat)), height, rowbytes, bpp)
    rows = np.frombuffer(raw, np.uint8).reshape(height, rowbytes)
    if depth < 8:
        bits = np.unpackbits(rows, axis=1).reshape(height, -1, depth)
        vals = np.zeros(bits.shape[:2], np.uint16)
        for j in range(depth):
            vals = (vals << 1) | bits[:, :, j]
        a = vals[:, :width].astype(np.uint8)
        if ctype == 0:
            a = (a * (255 // ((1 << depth) - 1))).astype(np.uint8)
    else:
        a = rows.reshape(height, width, channels)
        if channels == 1:
            a = a[:, :, 0]
    if ctype == 3 and palette is None:
        raise ValueError("PNG: palette image without PLTE")
    return _PNG_MODES[ctype], np.ascontiguousarray(a), palette


# --- PPM / PGM and BMP -------------------------------------------------------


def decode_pnm(data: bytes) -> Image:
    fields = []
    pos = 2
    while len(fields) < 3:
        while data[pos:pos + 1].isspace():
            pos += 1
        if data[pos:pos + 1] == b"#":
            pos = data.index(b"\n", pos) + 1
            continue
        start = pos
        while not data[pos:pos + 1].isspace():
            pos += 1
        fields.append(int(data[start:pos]))
    pos += 1
    width, height, maxval = fields
    if maxval != 255:
        raise ValueError(f"PNM: maxval {maxval}")
    channels = 3 if data[:2] == b"P6" else 1
    a = np.frombuffer(data, np.uint8, width * height * channels, pos)
    if channels == 1:
        return "L", a.reshape(height, width).copy(), None
    return "RGB", a.reshape(height, width, 3).copy(), None


def decode_bmp(data: bytes) -> Image:
    offset = struct.unpack("<I", data[10:14])[0]
    width, height, _, bits, compression = struct.unpack("<iiHHI",
                                                        data[18:34])
    if bits not in (24, 32) or compression != 0:
        raise ValueError(f"BMP: {bits}-bit, compression {compression}")
    channels = bits // 8
    rowbytes = (width * channels + 3) // 4 * 4
    rows = np.frombuffer(data, np.uint8, rowbytes * abs(height), offset)
    a = rows.reshape(abs(height), rowbytes)[:, :width * channels]
    a = a.reshape(abs(height), width, channels)[:, :, 2::-1]
    if height > 0:  # bottom-up
        a = a[::-1]
    return "RGB", np.ascontiguousarray(a), None


def load(path: str, width: int, height: int, mode: str) -> np.ndarray:
    """The file at ``path`` as PIL's
    ``Image.open(path).convert(mode).resize((width, height))`` gives it:
    [height, width, 3] (``"RGB"``) or [height, width] (``"L"``) uint8."""
    return resize(convert(read(path), mode), width, height)
