"""JPEG decoding without PIL, bit for bit as PIL decodes it.

The JAX package opens uploads and CLI inputs with PIL, whose JPEG decoder
is libjpeg-turbo with its defaults; the GPU host has no PIL. This module
decodes the same files to the same pixels:

  * markers: SOI, APPn and COM (skipped; APP0 "JFIF" and APP14 "Adobe"
    read for the colour space), DQT (8- and 16-bit tables), SOF0, SOF1 and
    SOF2 (8-bit samples, 1, 3 or 4 components), DHT, SOS (interleaved or
    not, one scan or several), DRI with RST0-7, EOI;
  * progressive files (SOF2, ``jdphuff.c``): DC first and refine scans,
    AC first and refine scans with end-of-band runs, into one coefficient
    buffer for the whole image, then the same transform as a sequential
    file. libjpeg smooths the blocks (``jdcoefct.c``) only while some
    coefficient bits are still unknown at output, which a complete file
    never leaves; a file that stops before its last scan raises
    ``ValueError`` instead;
  * entropy decoding: Huffman, through one 16-bit lookahead table per DHT
    table whose entries also hold the coefficient's extra bits when code
    and bits fit in 16 (libjpeg-turbo's fast path), so a symbol costs one
    table read in Python;
  * inverse DCT: libjpeg's ISLOW integer transform (``jidctint.c``: 13
    constant bits, 2 pass-1 bits, both passes descaled with rounding, the
    post-IDCT range-limit table), in numpy over all blocks at once;
  * chroma upsampling (``jdsample.c``): fancy triangle filters for h2v1,
    h1v2 and h2v2, the sample at the edge of the component's real width or
    height standing in for its missing neighbour; plain replication for
    h2v1 and h2v2 on a component at most 2 samples wide and for any other
    integer ratio;
  * colour (``jdcolor.c``): the fixed-point YCbCr -> RGB tables, 16
    fraction bits; 4 components are CMYK, or YCCK under an Adobe marker
    with transform 2 (``ycck_cmyk_convert``), stored inverted as Adobe
    writes them (PIL's "CMYK;I"), and become RGB as PIL's
    ``convert("RGB")`` computes it (``cmyk2rgb``).

Lossless (SOF3), hierarchical (SOF5-7) and arithmetic-coded (SOF9-15,
DAC) files and 12-bit samples raise ``ValueError`` naming the format.
"""

from __future__ import annotations

import re
import struct

import numpy as np

# zigzag position k -> natural (row-major) index in the 8x8 block
ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63])

_REFUSED = {
    0xC3: "lossless JPEG (SOF3)",
    0xC5: "hierarchical JPEG (SOF5)", 0xC6: "hierarchical JPEG (SOF6)",
    0xC7: "hierarchical JPEG (SOF7)",
    0xC9: "arithmetic-coded JPEG (SOF9)", 0xCA: "arithmetic-coded JPEG "
    "(SOF10)", 0xCB: "arithmetic-coded JPEG (SOF11)",
    0xCC: "arithmetic-coded JPEG (DAC)",
    0xCD: "arithmetic-coded JPEG (SOF13)", 0xCE: "arithmetic-coded JPEG "
    "(SOF14)", 0xCF: "arithmetic-coded JPEG (SOF15)",
}
_RST = re.compile(rb"\xff+[\xd0-\xd7]")

_TRUNCATED = ("truncated progressive JPEG: the file ends before its EOI "
              "or before its scans make the first ten coefficients exact "
              "(libjpeg would smooth the blocks; not decoded)")

# an AC entry's run for end-of-block, and for a code no table holds
_EOB, _BAD = -1, -2


def _huffman_luts(counts: bytes, symbols: bytes, ac: bool) -> list:
    """A DHT table -> a list indexed by the next 16 bits of the stream.

    DC entries are ``(bits, diff)``: the code and its extra bits are
    ``bits`` long and the DC difference is ``diff``; when the two do not
    fit in 16 bits the entry is ``(-code_length, extra_bits)`` and the
    caller reads them. AC entries are ``(bits, run, value)`` the same
    way (``(-code_length, run, extra_bits)`` when they do not fit);
    ZRL is a zero of run 15, end-of-block has run ``_EOB``. Bit strings
    that start no code map to ``(0, _BAD[, 0])``."""
    n = 1 << 16
    nbits = np.zeros(n, np.int64)
    run = np.full(n, _BAD, np.int64)
    value = np.zeros(n, np.int64)
    code, k = 0, 0
    for length in range(1, 17):
        for _ in range(counts[length - 1]):
            if k >= len(symbols):
                raise ValueError("corrupt JPEG: DHT has fewer symbols than "
                                 "its counts")
            sym = symbols[k]
            k += 1
            r, s = (sym >> 4, sym & 15) if ac else (0, sym)
            if ac and s == 0:
                r = 15 if r == 15 else _EOB     # ZRL (F/0) or EOB (0/0)
            shift = 16 - length
            lo, hi = code << shift, (code + 1) << shift
            if hi > n:
                raise ValueError("corrupt JPEG: bad Huffman table")
            if length + s <= 16:
                # every value of the s extra bits that follow the code
                idx = np.arange(lo, hi)
                v = (idx >> (shift - s)) & ((1 << s) - 1)
                if s:
                    v = np.where(v < (1 << (s - 1)), v - (1 << s) + 1, v)
                nbits[lo:hi] = length + s
                value[lo:hi] = v
            else:
                nbits[lo:hi] = -length
                value[lo:hi] = s
            run[lo:hi] = r
            code += 1
        code <<= 1
    if ac:
        return list(zip(nbits.tolist(), run.tolist(), value.tolist()))
    nbits[run == _BAD] = 0
    return list(zip(nbits.tolist(), value.tolist()))


def _symbol_lut(counts: bytes, symbols: bytes) -> list:
    """A DHT table -> a list indexed by the next 16 bits of the stream of
    ``(code length, symbol)``, length 0 for bit strings that start no code
    (the progressive scans read the symbol's extra bits themselves)."""
    n = 1 << 16
    length_of = np.zeros(n, np.int64)
    symbol_of = np.zeros(n, np.int64)
    code, k = 0, 0
    for length in range(1, 17):
        for _ in range(counts[length - 1]):
            shift = 16 - length
            if k >= len(symbols) or (code + 1) << shift > n:
                raise ValueError("corrupt JPEG: bad Huffman table")
            length_of[code << shift:(code + 1) << shift] = length
            symbol_of[code << shift:(code + 1) << shift] = symbols[k]
            code += 1
            k += 1
        code <<= 1
    return list(zip(length_of.tolist(), symbol_of.tolist()))


class _Table:
    """One DHT table; its lookup lists are built on first use (a
    progressive file defines a table for nearly every scan)."""

    def __init__(self, counts: bytes, symbols: bytes, ac: bool):
        self.counts, self.symbols, self.ac = counts, symbols, ac
        self._fast = self._raw = None

    @property
    def fast(self) -> list:
        if self._fast is None:
            self._fast = _huffman_luts(self.counts, self.symbols, self.ac)
        return self._fast

    @property
    def raw(self) -> list:
        if self._raw is None:
            self._raw = _symbol_lut(self.counts, self.symbols)
        return self._raw


def _windows(segment: bytes) -> list:
    """Unstuffed entropy-coded bytes -> ``w[p]``, the big-endian 32 bits
    that start at byte p (zeros past the end, as libjpeg fills a stream
    that runs out)."""
    b = np.frombuffer(segment + bytes(8), np.uint8).astype(np.int64)
    return ((b[:-3] << 24) | (b[1:-2] << 16) | (b[2:-1] << 8)
            | b[3:]).tolist()


def _extra(win: list, pos: int, s: int) -> int:
    """The s-bit signed value (JPEG's receive + extend) at bit ``pos``."""
    v = (win[pos >> 3] >> (32 - (pos & 7) - s)) & ((1 << s) - 1)
    return v - (1 << s) + 1 if v < (1 << (s - 1)) else v


def _decode_interval(win: list, slots: list, mcus: range, mcux: int,
                     coefs: list) -> None:
    """Huffman-decode the MCUs ``mcus`` of one restart interval into
    ``coefs`` (per component, 64 zigzag-ordered ints per block)."""
    pos = 0
    pred = [0] * len(coefs)
    for m in mcus:
        my, mx = divmod(m, mcux)
        for ci, dlut, alut, vs, hs, dy, dx, bw in slots:
            out = coefs[ci]
            base = ((my * vs + dy) * bw + mx * hs + dx) << 6
            n, v = dlut[(win[pos >> 3] >> (16 - (pos & 7))) & 0xFFFF]
            if n > 0:
                pos += n
            elif n < 0:
                pos -= n
                if v:
                    d = _extra(win, pos, v)
                    pos += v
                    v = d
            else:
                raise ValueError("corrupt JPEG: bad DC Huffman code")
            pred[ci] += v
            out[base] = pred[ci]
            k = 1
            while k < 64:
                n, r, v = alut[(win[pos >> 3] >> (16 - (pos & 7))) & 0xFFFF]
                if r < 0:
                    if r == _BAD:
                        raise ValueError("corrupt JPEG: bad AC Huffman code")
                    pos += n
                    break
                if n > 0:
                    pos += n
                else:
                    pos -= n
                    d = _extra(win, pos, v)
                    pos += v
                    v = d
                k += r
                out[base + k] = v
                k += 1
            if k > 64:
                raise ValueError("corrupt JPEG: AC run past the block")


def _get(win: list, pos: int, n: int) -> int:
    """The n unsigned bits at bit ``pos``."""
    return (win[pos >> 3] >> (32 - (pos & 7) - n)) & ((1 << n) - 1)


def _symbol(win: list, pos: int, lut: list) -> tuple:
    n, sym = lut[(win[pos >> 3] >> (16 - (pos & 7))) & 0xFFFF]
    if n == 0:
        raise ValueError("corrupt JPEG: bad Huffman code")
    return n, sym


def _dc_first(win, blocks, coefs, al) -> None:
    pos = 0
    pred = [0] * len(coefs)
    for ci, base, lut in blocks:
        n, s = _symbol(win, pos, lut)
        pos += n
        if s:
            v = _extra(win, pos, s)
            pos += s
            pred[ci] += v
        coefs[ci][base] = pred[ci] << al


def _dc_refine(win, blocks, coefs, al) -> None:
    p1 = 1 << al
    for pos, (ci, base, _) in enumerate(blocks):
        if _get(win, pos, 1):
            coefs[ci][base] |= p1


def _ac_first(win, blocks, coefs, ss, se, al) -> None:
    """``decode_mcu_AC_first``: one component, end-of-band runs."""
    pos = eobrun = 0
    for ci, base, lut in blocks:
        if eobrun:
            eobrun -= 1
            continue
        out = coefs[ci]
        k = ss
        while k <= se:
            n, sym = _symbol(win, pos, lut)
            pos += n
            r, s = sym >> 4, sym & 15
            if s:
                k += r
                if k > se:
                    raise ValueError("corrupt JPEG: AC run past the band")
                out[base + k] = _extra(win, pos, s) << al
                pos += s
            elif r == 15:
                k += 15
            else:
                eobrun = 1 << r
                if r:
                    eobrun += _get(win, pos, r)
                    pos += r
                eobrun -= 1
                break
            k += 1


def _ac_refine(win, blocks, coefs, ss, se, al) -> None:
    """``decode_mcu_AC_refine``: one more bit of every coefficient already
    non-zero, and new coefficients of magnitude 1 << al."""
    p1, m1 = 1 << al, -1 << al
    pos = eobrun = 0
    for ci, base, lut in blocks:
        out = coefs[ci]
        k = ss
        if not eobrun:
            while k <= se:
                n, sym = _symbol(win, pos, lut)
                pos += n
                r, s = sym >> 4, sym & 15
                if s:
                    # a new coefficient is always of size 1
                    s = p1 if _get(win, pos, 1) else m1
                    pos += 1
                elif r != 15:
                    eobrun = 1 << r
                    if r:
                        eobrun += _get(win, pos, r)
                        pos += r
                    break
                # skip r zero coefficients, refining the non-zero ones
                while k <= se:
                    c = out[base + k]
                    if c:
                        if _get(win, pos, 1) and not c & p1:
                            out[base + k] = c + (p1 if c >= 0 else m1)
                        pos += 1
                    else:
                        r -= 1
                        if r < 0:
                            break
                    k += 1
                if s:
                    if k > se:
                        raise ValueError("corrupt JPEG: AC run past the band")
                    out[base + k] = s
                k += 1
        if eobrun:
            while k <= se:
                c = out[base + k]
                if c:
                    if _get(win, pos, 1) and not c & p1:
                        out[base + k] = c + (p1 if c >= 0 else m1)
                    pos += 1
                k += 1
            eobrun -= 1


# libjpeg's ISLOW constants (jidctint.c), CONST_BITS = 13
_CONST_BITS, _PASS1_BITS = 13, 2
_F0298, _F0390, _F0541, _F0765 = 2446, 3196, 4433, 6270
_F0899, _F1175, _F1501, _F1847 = 7373, 9633, 12299, 15137
_F1961, _F2053, _F2562, _F3072 = 16069, 16819, 20995, 25172


def _idct_1d(x: list, shift: int) -> list:
    """One ISLOW pass over the 8 inputs ``x`` (int64 arrays), each output
    descaled by ``shift`` bits with rounding."""
    z2, z3 = x[2], x[6]
    z1 = (z2 + z3) * _F0541
    tmp2 = z1 - z3 * _F1847
    tmp3 = z1 + z2 * _F0765
    tmp0 = (x[0] + x[4]) << _CONST_BITS
    tmp1 = (x[0] - x[4]) << _CONST_BITS
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    t0, t1, t2, t3 = x[7], x[5], x[3], x[1]
    z1, z2, z3, z4 = t0 + t3, t1 + t2, t0 + t2, t1 + t3
    z5 = (z3 + z4) * _F1175
    t0, t1, t2, t3 = t0 * _F0298, t1 * _F2053, t2 * _F3072, t3 * _F1501
    z1, z2 = z1 * -_F0899, z2 * -_F2562
    z3, z4 = z3 * -_F1961 + z5, z4 * -_F0390 + z5
    t0 += z1 + z3
    t1 += z2 + z4
    t2 += z2 + z3
    t3 += z1 + z4
    half = 1 << (shift - 1)
    return [(a + half) >> shift for a in (
        tmp10 + t3, tmp11 + t2, tmp12 + t1, tmp13 + t0,
        tmp13 - t0, tmp12 - t1, tmp11 - t2, tmp10 - t3)]


def idct_islow(coefs: np.ndarray, qtable: np.ndarray) -> np.ndarray:
    """Dequantize and inverse-transform blocks as ``jpeg_idct_islow``:
    int [N, 64] natural-order coefficients, [64] quantizer -> uint8
    [N, 8, 8]."""
    c = (coefs.astype(np.int64) * qtable.astype(np.int64)).reshape(-1, 8, 8)
    # pass 1: columns (the 8 rows of each column) -> work array
    ws = np.stack(_idct_1d([c[:, k, :] for k in range(8)],
                           _CONST_BITS - _PASS1_BITS), axis=1)
    # pass 2: rows
    out = np.stack(_idct_1d([ws[:, :, k] for k in range(8)],
                            _CONST_BITS + _PASS1_BITS + 3), axis=2)
    # the post-IDCT range-limit table: index (x & 1023) as a signed
    # 10-bit value, centred on 128 and clamped
    idx = out & 1023
    idx = np.where(idx >= 512, idx - 1024, idx)
    return np.clip(idx + 128, 0, 255).astype(np.uint8)


def _fancy_h2(x: np.ndarray, near_bias: int, far_bias: int,
              shift: int) -> np.ndarray:
    """Horizontal triangle 2x along the last axis: output 2j is
    ``(3 x[j] + x[j-1] + near_bias) >> shift``, 2j+1 is ``(3 x[j] +
    x[j+1] + far_bias) >> shift``, the edge sample standing in for its
    missing neighbour."""
    left = np.concatenate([x[..., :1], x[..., :-1]], axis=-1)
    right = np.concatenate([x[..., 1:], x[..., -1:]], axis=-1)
    out = np.empty(x.shape[:-1] + (2 * x.shape[-1],), np.int64)
    out[..., 0::2] = (3 * x + left + near_bias) >> shift
    out[..., 1::2] = (3 * x + right + far_bias) >> shift
    return out


def _vertical_sums(x: np.ndarray) -> tuple:
    """(3 x[i] + x[i-1], 3 x[i] + x[i+1]) per row, edge rows repeated."""
    up = np.concatenate([x[:1], x[:-1]], axis=0)
    down = np.concatenate([x[1:], x[-1:]], axis=0)
    return 3 * x + up, 3 * x + down


def upsample(plane: np.ndarray, h_ratio: int, v_ratio: int) -> np.ndarray:
    """One component's samples (its real downsampled size) -> the
    full-resolution grid, as libjpeg-turbo's ``jdsample.c`` does with
    fancy upsampling on."""
    x = plane.astype(np.int64)
    w = x.shape[1]
    if (h_ratio, v_ratio) == (1, 1):
        return plane
    if (h_ratio, v_ratio) == (2, 1) and w > 2:
        out = _fancy_h2(x, 1, 2, 2)                     # h2v1_fancy_upsample
    elif (h_ratio, v_ratio) == (1, 2):
        above, below = _vertical_sums(x)                # h1v2_fancy_upsample
        out = np.empty((2 * x.shape[0], w), np.int64)
        out[0::2] = (above + 1) >> 2
        out[1::2] = (below + 2) >> 2
    elif (h_ratio, v_ratio) == (2, 2) and w > 2:
        above, below = _vertical_sums(x)                # h2v2_fancy_upsample
        out = np.empty((2 * x.shape[0], 2 * w), np.int64)
        out[0::2] = _fancy_h2(above, 8, 7, 4)
        out[1::2] = _fancy_h2(below, 8, 7, 4)
    else:
        out = np.repeat(np.repeat(x, v_ratio, axis=0), h_ratio, axis=1)
    return out.astype(np.uint8)


_SCALE = 1 << 16


def _fix(v: float) -> int:
    return int(v * _SCALE + 0.5)


def ycc_to_rgb(y: np.ndarray, cb: np.ndarray, cr: np.ndarray) -> np.ndarray:
    """``jdcolor.c``'s ycc_rgb_convert: uint8 planes -> uint8 [H, W, 3]."""
    return np.clip(_ycc_unclipped(y, cb, cr), 0, 255).astype(np.uint8)


def _ycc_unclipped(y: np.ndarray, cb: np.ndarray, cr: np.ndarray):
    x = np.arange(256, dtype=np.int64) - 128
    half = 1 << 15
    cr_r = (_fix(1.40200) * x + half) >> 16
    cb_b = (_fix(1.77200) * x + half) >> 16
    cr_g = -_fix(0.71414) * x
    cb_g = -_fix(0.34414) * x + half
    y = y.astype(np.int64)
    r = y + cr_r[cr]
    g = y + ((cb_g[cb] + cr_g[cr]) >> 16)
    b = y + cb_b[cb]
    return np.stack([r, g, b], axis=-1)


def _segment(data: bytes, pos: int) -> tuple:
    """The marker segment at ``pos`` (its length field) -> (body, next)."""
    if pos + 2 > len(data):
        raise ValueError("corrupt JPEG: truncated marker segment")
    (n,) = struct.unpack(">H", data[pos:pos + 2])
    if n < 2 or pos + n > len(data):
        raise ValueError("corrupt JPEG: truncated marker segment")
    return data[pos + 2:pos + n], pos + n


def _scan_end(data: bytes, pos: int) -> int:
    """The offset of the first marker after entropy-coded data at
    ``pos`` that is not a restart marker (or the end of the data)."""
    while True:
        pos = data.find(b"\xff", pos)
        if pos < 0 or pos + 1 >= len(data):
            return len(data)
        nxt = data[pos + 1]
        if nxt == 0 or 0xD0 <= nxt <= 0xD7 or nxt == 0xFF:
            pos += 1 if nxt == 0xFF else 2
            continue
        return pos


class _Frame:
    def __init__(self, body: bytes, progressive: bool = False):
        precision, self.height, self.width, n = struct.unpack(
            ">BHHB", body[:6])
        if precision != 8:
            raise ValueError(f"{precision}-bit JPEG is not decoded (8-bit "
                             "samples only)")
        if n not in (1, 3, 4):
            raise ValueError(f"JPEG with {n} components is not decoded "
                             "(1, 3 or 4 only)")
        self.progressive = progressive
        # per component and zigzag index, the lowest bit a scan has sent
        # (-1: none yet), as libjpeg's coef_bits
        self.coef_bits = [[-1] * 64 for _ in range(n)]
        if self.height == 0 or self.width == 0:
            raise ValueError("JPEG with a DNL-defined or zero size is not "
                             "decoded")
        self.ids, self.h, self.v, self.tq = [], [], [], []
        for i in range(n):
            cid, hv, tq = body[6 + 3 * i:9 + 3 * i]
            h, v = hv >> 4, hv & 15
            if not (1 <= h <= 4 and 1 <= v <= 4):
                raise ValueError("corrupt JPEG: bad sampling factors")
            self.ids.append(cid)
            self.h.append(h)
            self.v.append(v)
            self.tq.append(tq)
        self.hmax, self.vmax = max(self.h), max(self.v)
        for h, v in zip(self.h, self.v):
            if self.hmax % h or self.vmax % v:
                raise ValueError("JPEG with fractional chroma sampling is "
                                 "not decoded")
        self.mcux = -(-self.width // (8 * self.hmax))
        self.mcuy = -(-self.height // (8 * self.vmax))
        # each component's real size and padded block grid
        self.dw = [-(-self.width * h // self.hmax) for h in self.h]
        self.dh = [-(-self.height * v // self.vmax) for v in self.v]
        self.bw = [self.mcux * h for h in self.h]
        self.bh = [self.mcuy * v for v in self.v]
        self.coefs = [[0] * (bw * bh * 64) for bw, bh in zip(self.bw,
                                                            self.bh)]
        self.qtables: list = [None] * n


def _decode_scan(frame: _Frame, body: bytes, entropy: bytes, dc: dict,
                 ac: dict, qt: dict, restart: int) -> None:
    ns = body[0]
    comps = []
    for i in range(ns):
        cid, tables = body[1 + 2 * i:3 + 2 * i]
        if cid not in frame.ids:
            raise ValueError(f"corrupt JPEG: scan names component {cid}")
        comps.append((frame.ids.index(cid), tables >> 4, tables & 15))
    ss, se, ahal = body[1 + 2 * ns:4 + 2 * ns]
    ah, al = ahal >> 4, ahal & 15
    if not frame.progressive and (ss, se, ahal) != (0, 63, 0):
        raise ValueError("corrupt JPEG: a sequential scan with spectral "
                         f"selection {ss}-{se}, approximation {ahal}")
    if frame.progressive and (
            (ss == 0 and se != 0) or (ss > 0 and (se < ss or se > 63
                                                  or ns != 1))
            or (ah and al != ah - 1) or al > 13):
        raise ValueError("corrupt JPEG: bad progressive scan parameters "
                         f"{ss}-{se}, approximation {ah}/{al}")
    dc_refine = frame.progressive and ss == 0 and ah
    slots = []
    for ci, td, ta in comps:
        needs = ([] if dc_refine else [dc] if ss == 0 else [ac]) \
            if frame.progressive else [dc, ac]
        if any((td if t is dc else ta) not in t for t in needs):
            raise ValueError("corrupt JPEG: scan uses an undefined Huffman "
                             "table")
        if frame.tq[ci] not in qt:
            raise ValueError("corrupt JPEG: component uses an undefined "
                             "quantization table")
        if frame.qtables[ci] is None:     # latched on first use, as libjpeg
            frame.qtables[ci] = qt[frame.tq[ci]]
        if frame.progressive:
            lut = (None if dc_refine else
                   dc[td].raw if ss == 0 else ac[ta].raw)
            tabs = (lut,)
        else:
            tabs = (dc[td].fast, ac[ta].fast)
        if ns == 1:
            slots.append((ci, tabs, 1, 1, 0, 0, frame.bw[ci]))
        else:
            slots += [(ci, tabs, frame.v[ci], frame.h[ci], dy, dx,
                       frame.bw[ci]) for dy in range(frame.v[ci])
                      for dx in range(frame.h[ci])]
        for k in range(ss, se + 1):
            frame.coef_bits[ci][k] = al
    if ns == 1:
        ci = comps[0][0]
        mcux = -(-frame.dw[ci] // 8)
        total = mcux * -(-frame.dh[ci] // 8)
    else:
        mcux, total = frame.mcux, frame.mcux * frame.mcuy
    intervals = _RST.split(entropy) if restart else [entropy]
    step = restart or total
    for i, start in enumerate(range(0, total, step)):
        if i >= len(intervals):
            raise ValueError("corrupt JPEG: missing restart interval")
        win = _windows(intervals[i].replace(b"\xff\x00", b"\xff"))
        mcus = range(start, min(start + step, total))
        if not frame.progressive:
            _decode_interval(win, [(ci, t[0], t[1], vs, hs, dy, dx, bw)
                                   for ci, t, vs, hs, dy, dx, bw in slots],
                             mcus, mcux, frame.coefs)
            continue
        blocks = []
        for m in mcus:
            my, mx = divmod(m, mcux)
            blocks += [(ci, ((my * vs + dy) * bw + mx * hs + dx) << 6, t[0])
                       for ci, t, vs, hs, dy, dx, bw in slots]
        try:
            if ss == 0:
                (_dc_refine if ah else _dc_first)(win, blocks, frame.coefs,
                                                  al)
            elif ah:
                _ac_refine(win, blocks, frame.coefs, ss, se, al)
            else:
                _ac_first(win, blocks, frame.coefs, ss, se, al)
        except IndexError:
            raise ValueError(_TRUNCATED) from None


def _would_smooth(frame: _Frame) -> bool:
    """libjpeg-turbo's ``smoothing_ok`` (jdcoefct.c): every component's DC
    is known and its first ten quantizers are nonzero, and in some
    component one of zigzag coefficients 1-9 is not exact to bit 0. Then
    libjpeg smooths the blocks on output; otherwise it decodes the
    coefficients as they stand, those never sent as zeros."""
    useful = False
    for q, bits in zip(frame.qtables, frame.coef_bits):
        if bits[0] < 0 or not q[ZIGZAG[:10]].all():
            return False
        useful = useful or any(b != 0 for b in bits[1:10])
    return useful


def _color_space(frame: _Frame, jfif: bool, adobe) -> str:
    """libjpeg's default_decompress_parms for 3 components."""
    if jfif:
        return "ycc"
    if adobe is not None:
        return "rgb" if adobe == 0 else "ycc"
    return "rgb" if frame.ids == [82, 71, 66] else "ycc"


def ycck_to_cmyk(y, cb, cr, k) -> list:
    """``jdcolor.c``'s ycck_cmyk_convert: C, M, Y are 255 minus the RGB
    that the YCbCr tables give, K passes through."""
    return [np.clip(255 - p.astype(np.int64), 0, 255).astype(np.uint8)
            for p in np.moveaxis(_ycc_unclipped(y, cb, cr), -1, 0)] + [k]


def cmyk_to_rgb(planes: list) -> np.ndarray:
    """Inverted (Adobe) CMYK planes as libjpeg returns them -> RGB as PIL
    computes it: "CMYK;I" inverts each plane, then ``cmyk2rgb`` takes
    ``nk - nk * c / 255`` with nk = 255 - k, in PIL's MULDIV255 integer
    rounding."""
    c, m, y, k = (255 - p.astype(np.int64) for p in planes)
    nk = 255 - k

    def muldiv255(a, b):
        t = a * b + 128
        return ((t >> 8) + t) >> 8
    return np.clip(np.stack([nk - muldiv255(x, nk) for x in (c, m, y)], -1),
                   0, 255).astype(np.uint8)


def decode_jpeg(data: bytes) -> np.ndarray:
    """A JPEG file's bytes -> uint8 [H, W, 1] (gray) or [H, W, 3] (RGB;
    CMYK and YCCK files as PIL's ``convert("RGB")``), the pixels PIL
    decodes."""
    try:
        return _decode(data)
    except (IndexError, struct.error):
        raise ValueError("corrupt JPEG: a truncated marker segment") from None


def _decode(data: bytes) -> np.ndarray:
    if data[:2] != b"\xff\xd8":
        raise ValueError("not a JPEG file (no SOI marker)")
    pos, frame = 2, None
    dc: dict = {}
    ac: dict = {}
    qt: dict = {}
    restart, jfif, adobe, ended = 0, False, None, False
    while True:
        pos = data.find(b"\xff", pos)
        if pos < 0 or pos + 1 >= len(data):
            break
        marker = data[pos + 1]
        pos += 2
        if marker in (0xFF, 0x00) or 0xD0 <= marker <= 0xD7:
            pos -= 1 if marker == 0xFF else 0
            continue
        if marker == 0xD9:                                      # EOI
            ended = True
            break
        if marker in _REFUSED:
            raise ValueError(f"{_REFUSED[marker]} is not decoded: only "
                             "baseline and extended sequential Huffman JPEG")
        body, pos = _segment(data, pos)
        if marker in (0xC0, 0xC1, 0xC2):                       # SOF0/1/2
            if frame is not None:
                raise ValueError("corrupt JPEG: two frame headers")
            frame = _Frame(body, progressive=marker == 0xC2)
        elif marker == 0xC4:                                    # DHT
            i = 0
            while i < len(body):
                tc_th = body[i]
                counts = body[i + 1:i + 17]
                n = sum(counts)
                symbols = body[i + 17:i + 17 + n]
                if len(counts) < 16 or len(symbols) < n:
                    raise ValueError("corrupt JPEG: truncated DHT")
                (ac if tc_th >> 4 else dc)[tc_th & 15] = _Table(
                    counts, symbols, bool(tc_th >> 4))
                i += 17 + n
        elif marker == 0xDB:                                    # DQT
            i = 0
            while i < len(body):
                pq, tq = body[i] >> 4, body[i] & 15
                size = 128 if pq else 64
                raw = body[i + 1:i + 1 + size]
                if len(raw) < size:
                    raise ValueError("corrupt JPEG: truncated DQT")
                vals = np.frombuffer(raw, ">u2" if pq else np.uint8)
                table = np.zeros(64, np.int64)
                table[ZIGZAG] = vals
                qt[tq] = table
                i += 1 + size
        elif marker == 0xDD:                                    # DRI
            (restart,) = struct.unpack(">H", body[:2])
        elif marker == 0xDA:                                    # SOS
            if frame is None:
                raise ValueError("corrupt JPEG: scan before the frame header")
            end = _scan_end(data, pos)
            _decode_scan(frame, body, data[pos:end], dc, ac, qt, restart)
            pos = end
        elif marker == 0xE0 and body[:5] == b"JFIF\x00":
            jfif = True
        elif marker == 0xEE and body[:5] == b"Adobe" and len(body) >= 12:
            adobe = body[11]
        elif marker == 0xDC:
            raise ValueError("JPEG with a DNL marker is not decoded")
    if frame is None or any(q is None for q in frame.qtables):
        raise ValueError("corrupt JPEG: no frame, or a component no scan "
                         "covers")
    if frame.progressive and (not ended or _would_smooth(frame)):
        raise ValueError(_TRUNCATED)
    planes = []
    for ci in range(len(frame.ids)):
        bw, bh = frame.bw[ci], frame.bh[ci]
        zz = np.asarray(frame.coefs[ci], np.int64).reshape(-1, 64)
        nat = np.empty_like(zz)
        nat[:, ZIGZAG] = zz
        blocks = idct_islow(nat, frame.qtables[ci])
        plane = blocks.reshape(bh, bw, 8, 8).transpose(0, 2, 1, 3).reshape(
            bh * 8, bw * 8)[:frame.dh[ci], :frame.dw[ci]]
        plane = upsample(plane, frame.hmax // frame.h[ci],
                         frame.vmax // frame.v[ci])
        planes.append(plane[:frame.height, :frame.width])
    if len(planes) == 1:
        return planes[0][:, :, None]
    if len(planes) == 4:
        if adobe == 2:
            planes = ycck_to_cmyk(*planes)
        return cmyk_to_rgb(planes)
    if _color_space(frame, jfif, adobe) == "rgb":
        return np.stack(planes, axis=-1)
    return ycc_to_rgb(*planes)
