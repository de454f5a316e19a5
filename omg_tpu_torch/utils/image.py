"""Image files without PIL: the PNG files the CLIs read and write, the
JPEG and PNG photos they and the server read, and the resize of a
condition image (the JAX CLIs call PIL, which the GPU host lacks).

``write_png`` writes 8-bit gray, RGB or RGBA, unfiltered rows in one
zlib stream. ``read_png`` reads 8-bit gray, RGB and RGBA, non-interlaced,
with any of the five row filters; another format (palette, 16-bit,
interlaced) raises and names it. The Average and Paeth filters undo
byte by byte in Python: a 1024x1024 RGB file that uses them takes
seconds. ``decode_image`` reads PNG or baseline JPEG by the file's
signature (``utils/jpeg``); ``read_rgb`` reads either and converts as
PIL's ``convert("RGB")`` does: gray repeated over three channels, alpha
dropped. ``resize`` is
``Image.resize((w, h))``'s default for RGB, antialiased bicubic, or PIL's
Lanczos: PIL's own passes (``segment/evit_ops.pil_resize_uint8``), bit
for bit. ``encode_png``/``decode_png`` are the same formats in memory
(the server's base64 payloads).
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

from omg_tpu_torch.segment import evit_ops
from omg_tpu_torch.utils import jpeg

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 6: 4}          # PNG color type -> channels
_COLOR_TYPES = {v: k for k, v in _CHANNELS.items()}


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def write_png(path: str, image: np.ndarray) -> None:
    """uint8 [H, W] or [H, W, C] (C = 1, 3 or 4) -> an 8-bit PNG file."""
    with open(path, "wb") as f:
        f.write(encode_png(image))


def encode_png(image: np.ndarray) -> bytes:
    """uint8 [H, W] or [H, W, C] (C = 1, 3 or 4) -> 8-bit PNG bytes."""
    img = np.asarray(image)
    if img.dtype != np.uint8:
        raise ValueError(f"write_png takes uint8, not {img.dtype}")
    if img.ndim == 2:
        img = img[:, :, None]
    h, w, c = img.shape
    if c not in _COLOR_TYPES:
        raise ValueError(f"write_png: {c} channels (1, 3 or 4 only)")
    rows = np.concatenate([np.zeros((h, 1), np.uint8),
                           np.ascontiguousarray(img).reshape(h, w * c)], 1)
    return (_SIGNATURE
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8,
                                          _COLOR_TYPES[c], 0, 0, 0))
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + _chunk(b"IEND", b""))


def _paeth(a: int, b: int, c: int) -> int:
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def _unfilter(kind: int, row: np.ndarray, prev: np.ndarray,
              bpp: int) -> np.ndarray:
    """One scanline's filter undone (PNG spec, section 9)."""
    if kind == 0:
        return row
    if kind == 2:
        return row + prev                          # uint8: mod 256
    if kind == 1:
        px = row.reshape(-1, bpp).astype(np.int64)
        return (np.cumsum(px, axis=0) % 256).astype(np.uint8).reshape(-1)
    if kind not in (3, 4):
        raise ValueError(f"PNG row filter {kind} (0-4 only)")
    out = bytearray(row.tobytes())
    up = prev.tolist()
    for i in range(len(out)):
        a = out[i - bpp] if i >= bpp else 0
        if kind == 3:
            pred = (a + up[i]) >> 1
        else:
            pred = _paeth(a, up[i], up[i - bpp] if i >= bpp else 0)
        out[i] = (out[i] + pred) & 0xFF
    return np.frombuffer(bytes(out), np.uint8)


def read_png(path: str) -> np.ndarray:
    """An 8-bit gray, RGB or RGBA PNG -> uint8 [H, W, C], C = 1, 3 or 4."""
    with open(path, "rb") as f:
        return decode_png(f.read(), path)


def decode_png(data: bytes, path: str = "PNG data") -> np.ndarray:
    """``read_png`` of bytes in memory (``path`` names them in errors)."""
    if data[:8] != _SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    pos, idat, header = 8, [], None
    while pos + 8 <= len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError(f"{path}: no IHDR chunk")
    w, h, depth, color, _, _, interlace = header
    if depth != 8 or color not in _CHANNELS or interlace:
        raise ValueError(
            f"{path}: PNG of bit depth {depth}, color type {color}"
            f"{', interlaced' if interlace else ''}; only 8-bit gray (0), "
            "RGB (2) and RGBA (6), non-interlaced, are read")
    c = _CHANNELS[color]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    stride = w * c + 1
    if raw.size != h * stride:
        raise ValueError(f"{path}: {raw.size} bytes of image data for "
                         f"{h} rows of {stride}")
    rows = raw.reshape(h, stride)
    out = np.empty((h, w * c), np.uint8)
    prev = np.zeros(w * c, np.uint8)
    for y in range(h):
        prev = out[y] = _unfilter(int(rows[y, 0]), rows[y, 1:], prev, c)
    return out.reshape(h, w, c)


def decode_image(data: bytes, path: str = "image data") -> np.ndarray:
    """PNG or baseline JPEG bytes -> uint8 [H, W, C], by the signature;
    another format raises and names ``path``."""
    if data[:8] == _SIGNATURE:
        return decode_png(data, path)
    if data[:3] == b"\xff\xd8\xff":
        try:
            return jpeg.decode_jpeg(data)
        except ValueError as e:
            raise ValueError(f"{path}: {e}") from None
    raise ValueError(f"{path}: neither a PNG nor a JPEG file")


def read_rgb(path: str) -> np.ndarray:
    """A PNG or baseline JPEG file -> uint8 [H, W, 3], as PIL's
    ``convert("RGB")`` gives it."""
    with open(path, "rb") as f:
        return to_rgb(decode_image(f.read(), path))


def to_rgb(img: np.ndarray) -> np.ndarray:
    """uint8 [H, W, 1|3|4] -> [H, W, 3]: gray repeated, alpha dropped."""
    if img.shape[2] == 1:
        return np.repeat(img, 3, axis=2)
    return np.ascontiguousarray(img[:, :, :3])


def resize(image: np.ndarray, height: int, width: int,
           filt: str = "bicubic") -> np.ndarray:
    """uint8 [H, W, C] -> [height, width, C]: PIL's
    ``resize((width, height))`` with its default filter for RGB
    (antialiased bicubic) or ``filt="lanczos"``."""
    return evit_ops.pil_resize_uint8(image, (height, width), filt)
