"""cv2's semantics without cv2, for exactly what the OpenPose condition
preprocessor calls (``omg_tpu/models/openpose.py``; the GPU host has no
cv2).

``resize_cubic`` is ``cv2.resize(..., interpolation=INTER_CUBIC)``:
source coordinate ``(dx + 0.5) * scale - 0.5`` taken in double and cast
to float, the four taps of the A = -0.75 kernel computed in float, taps
past an edge clamped to it. With ``fx``/``fy`` given, the size is
``round(w * fx)`` and the source step is ``1 / fx`` (not the ratio of
the sizes). On uint8 it is OpenCV's own fixed-point code, bit for bit:
11-bit tap weights, a horizontal pass in int, then the vertical pass of
its 128-bit SIMD loop (float32 steps, rounded half to even) with the
integer ``(sum + 2^21) >> 22`` on each row's last ``n % 8`` values, and
saturation. (An OpenCV built with the IPP HAL, as the opencv-python 5.0
wheel is, runs IPP's float resize instead, one level apart on a few per cent
of pixels.) Float maps go through torch's bicubic interpolation on their
own device (the same kernel, half-pixel centres and clamped taps; the
coordinates are taken in float, so the values agree with cv2's to about
1e-6 of the map's range).

The drawing primitives are cv2's integer rasterizers with 8-connected
lines: ``ellipse2poly`` (its 7-digit sine table, rounded vertices, runs
of equal vertices dropped), ``fill_convex_poly`` (the edges drawn as
Bresenham lines clipped to the image, then scanlines between two edges
walked in 16.16 fixed point), a filled ``circle`` (the midpoint circle's
horizontal spans), and ``add_weighted`` on uint8 (float weights, rounded
half to even, saturated).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

_COEF_BITS = 11                       # INTER_RESIZE_COEF_BITS
_XY_SHIFT = 16
_XY_ONE = 1 << _XY_SHIFT


def _cubic_taps(n_in: int, n_out: int, scale: float) -> tuple:
    """(first source index [n_out], float32 weights [n_out, 4]) of cv2's
    cubic resize along one axis; ``scale`` is source pixels per output
    pixel."""
    fx = ((np.arange(n_out) + 0.5) * scale - 0.5).astype(np.float32)
    sx = np.floor(fx)
    x = (fx - sx).astype(np.float32)
    a = np.float32(-0.75)
    one = np.float32(1)
    x1 = x + one
    c0 = ((a * x1 - 5 * a) * x1 + 8 * a) * x1 - 4 * a
    c1 = ((a + 2) * x - (a + 3)) * x * x + one
    y = one - x
    c2 = ((a + 2) * y - (a + 3)) * y * y + one
    c3 = one - c0 - c1 - c2
    return sx.astype(np.int64) - 1, np.stack([c0, c1, c2, c3], axis=1)


def _sizes(shape: tuple, dsize: Optional[Tuple[int, int]], fx: float,
           fy: float) -> tuple:
    """cv2's (out_h, out_w, scale_y, scale_x) for ``dsize`` (w, h) or
    ``fx``/``fy``."""
    h, w = shape[:2]
    if dsize is not None and dsize[0] > 0 and dsize[1] > 0:
        out_w, out_h = dsize
        return out_h, out_w, 1.0 / (out_h / h), 1.0 / (out_w / w)
    if fx <= 0 or fy <= 0:
        raise ValueError("resize_cubic needs dsize or fx and fy")
    # saturate_cast<int>(double) rounds half to even, as Python's round
    return round(h * fy), round(w * fx), 1.0 / fy, 1.0 / fx


def resize_cubic(image, dsize: Optional[Tuple[int, int]] = None, *,
                 fx: float = 0.0, fy: float = 0.0):
    """``cv2.resize(image, dsize, fx=fx, fy=fy,
    interpolation=cv2.INTER_CUBIC)``.

    ``image``: uint8 numpy [H, W] or [H, W, C] (cv2's fixed-point path,
    bit for bit), or a float tensor [B, C, H, W] (resized on its device).
    ``dsize`` is (width, height) as cv2 takes it."""
    if isinstance(image, torch.Tensor):
        out_h, out_w, sy, sx = _sizes(image.shape[-2:], dsize, fx, fy)
        if dsize is None or dsize[0] <= 0:
            # cv2's step 1/fx: torch takes 1/scale_factor when it is given
            return F.interpolate(image, scale_factor=(fy, fx),
                                 mode="bicubic", align_corners=False)
        return F.interpolate(image, size=(out_h, out_w), mode="bicubic",
                             align_corners=False)
    img = np.asarray(image)
    if img.dtype != np.uint8:
        raise ValueError(f"resize_cubic: numpy input must be uint8, not "
                         f"{img.dtype}; pass float maps as tensors")
    out_h, out_w, sy, sx = _sizes(img.shape, dsize, fx, fy)
    x = img.astype(np.int64)
    squeeze = x.ndim == 2
    if squeeze:
        x = x[:, :, None]
    h, w = x.shape[:2]
    scale = float(1 << _COEF_BITS)

    def fixed(c):
        # saturate_cast<short>(c * 2048): round half to even
        return np.rint(c.astype(np.float32) * np.float32(scale)).astype(
            np.int64)

    x0, cx = _cubic_taps(w, out_w, sx)
    acc = np.zeros((h, out_w, x.shape[2]), np.int64)
    wx = fixed(cx)
    for k in range(4):
        idx = np.clip(x0 + k, 0, w - 1)
        acc += x[:, idx] * wx[:, k][None, :, None]
    y0, cy = _cubic_taps(h, out_h, sy)
    wy = fixed(cy)
    rows = [acc[np.clip(y0 + k, 0, h - 1)].reshape(out_h, -1)
            for k in range(4)]
    # the vertical pass: cv2's 128-bit SIMD loop takes the row's first
    # 8*floor(n/8) values in float, S0*b0 + (S1*b1 + (S2*b2 + S3*b3))
    # with b = beta / 2^22, each step rounded to float32, then rounded
    # half to even; the rest take the integer form (sum + 2^21) >> 22
    n = rows[0].shape[1]
    vec = n - n % 8
    b = (wy.astype(np.float32) * np.float32(2.0 ** -(2 * _COEF_BITS)))
    f = [r[:, :vec].astype(np.float32) for r in rows]
    v = f[3] * b[:, 3:4]
    for k in (2, 1, 0):
        v = f[k] * b[:, k:k + 1] + v
    out = np.empty((out_h, n), np.int64)
    out[:, :vec] = np.rint(v).astype(np.int64)
    shift = 2 * _COEF_BITS
    tail = sum(r[:, vec:] * wy[:, k:k + 1] for k, r in enumerate(rows))
    out[:, vec:] = (tail + (1 << (shift - 1))) >> shift
    out = np.clip(out, 0, 255).astype(np.uint8).reshape(out_h, out_w, -1)
    return out[:, :, 0] if squeeze else out


# cv2's SinTable: sin of 0..450 degrees, 7 decimals, as float32
_SIN_TABLE = np.round(np.sin(np.deg2rad(np.arange(451))), 7).astype(
    np.float32).astype(np.float64)


def ellipse2poly(center: Tuple[int, int], axes: Tuple[int, int], angle: int,
                 arc_start: int, arc_end: int, delta: int) -> np.ndarray:
    """``cv2.ellipse2Poly``: the int32 [N, 2] (x, y) vertices."""
    if not 0 < delta <= 180:
        raise ValueError("ellipse2poly: delta must be in (0, 180]")
    while angle < 0:
        angle += 360
    while angle > 360:
        angle -= 360
    if arc_start > arc_end:
        arc_start, arc_end = arc_end, arc_start
    while arc_start < 0:
        arc_start += 360
        arc_end += 360
    while arc_end > 360:
        arc_end -= 360
        arc_start -= 360
    if arc_end - arc_start > 360:
        arc_start, arc_end = 0, 360
    alpha, beta = _SIN_TABLE[450 - angle], _SIN_TABLE[angle]   # cos, sin
    cx, cy = float(center[0]), float(center[1])
    pts = []
    for i in range(arc_start, arc_end + delta, delta):
        a = min(i, arc_end)
        if a < 0:
            a += 360
        x = axes[0] * _SIN_TABLE[450 - a]
        y = axes[1] * _SIN_TABLE[a]
        pts.append((cx + x * alpha - y * beta, cy + x * beta + y * alpha))
    if len(pts) == 1:
        pts = [(cx, cy)] * 2
    out = []
    for px, py in pts:
        p = (round(px), round(py))               # cvRound: half to even
        if not out or p != out[-1]:
            out.append(p)
    if len(out) == 1:
        out = [(int(center[0]), int(center[1]))] * 2
    return np.asarray(out, np.int32).reshape(-1, 2)


def _clip_line(w: int, h: int, x1: int, y1: int, x2: int,
               y2: int) -> Optional[tuple]:
    """cv2's ``clipLine`` to the image [0, w) x [0, h): the clipped ends,
    or None when the segment misses the image."""
    right, bottom = w - 1, h - 1

    def code(x, y):
        return (x < 0) + (x > right) * 2 + (y < 0) * 4 + (y > bottom) * 8

    def trunc(v: float) -> int:
        return int(v)                             # (int64)(double): to zero

    c1, c2 = code(x1, y1), code(x2, y2)
    if (c1 & c2) == 0 and (c1 | c2) != 0:
        if c1 & 12:
            a = 0 if c1 < 8 else bottom
            x1 += trunc((a - y1) * (x2 - x1) / (y2 - y1))
            y1 = a
            c1 = (x1 < 0) + (x1 > right) * 2
        if c2 & 12:
            a = 0 if c2 < 8 else bottom
            x2 += trunc((a - y2) * (x2 - x1) / (y2 - y1))
            y2 = a
            c2 = (x2 < 0) + (x2 > right) * 2
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1:
                a = 0 if c1 == 1 else right
                y1 += trunc((a - x1) * (y2 - y1) / (x2 - x1))
                x1 = a
                c1 = 0
            if c2:
                a = 0 if c2 == 1 else right
                y2 += trunc((a - x2) * (y2 - y1) / (x2 - x1))
                x2 = a
                c2 = 0
    return (x1, y1, x2, y2) if (c1 | c2) == 0 else None


def _line(img: np.ndarray, p1: tuple, p2: tuple, color) -> None:
    """cv2's 8-connected ``Line`` (a ``LineIterator`` left to right over
    the clipped segment, both ends included)."""
    h, w = img.shape[:2]
    x1, y1, x2, y2 = int(p1[0]), int(p1[1]), int(p2[0]), int(p2[1])
    if not (0 <= x1 < w and 0 <= x2 < w and 0 <= y1 < h and 0 <= y2 < h):
        clipped = _clip_line(w, h, x1, y1, x2, y2)
        if clipped is None:
            return
        x1, y1, x2, y2 = clipped
    dx, dy = x2 - x1, y2 - y1
    if dx < 0:
        x1, y1, x2, y2 = x2, y2, x1, y1
        dx, dy = -dx, -dy
    step_y = 1 if dy >= 0 else -1
    dy = abs(dy)
    vert = dy > dx
    if vert:
        dx, dy = dy, dx
    err = dx - 2 * dy
    x, y = x1, y1
    xs, ys = [], []
    for _ in range(dx + 1):
        xs.append(x)
        ys.append(y)
        minor = err < 0
        err += -2 * dy + (2 * dx if minor else 0)
        if vert:
            y += step_y
            x += 1 if minor else 0
        else:
            x += 1
            y += step_y if minor else 0
    img[ys, xs] = color


def _hline(img: np.ndarray, y: int, x1: int, x2: int, color) -> None:
    img[y, x1:x2 + 1] = color


def _trunc_div(a: int, b: int) -> int:
    """C's integer division (toward zero) for b > 0."""
    return a // b if a >= 0 else -((-a) // b)


def fill_convex_poly(img: np.ndarray, points, color) -> np.ndarray:
    """``cv2.fillConvexPoly(img, points, color)`` in place (8-connected
    edges, no sub-pixel shift); returns ``img``."""
    v = [(int(x), int(y)) for x, y in np.asarray(points).reshape(-1, 2)]
    npts = len(v)
    if npts == 0:
        return img
    h, w = img.shape[:2]
    color = np.asarray(color, img.dtype)[:img.shape[2] if img.ndim == 3
                                         else 1]
    xmin = xmax = v[0][0]
    ymin = ymax = v[0][1]
    imin = 0
    p0 = v[-1]
    for i, p in enumerate(v):
        if p[1] < ymin:
            ymin, imin = p[1], i
        ymax, xmax, xmin = max(ymax, p[1]), max(xmax, p[0]), min(xmin, p[0])
        _line(img, p0, p, color)
        p0 = p
    if npts < 3 or xmax < 0 or ymax < 0 or xmin >= w or ymin >= h:
        return img
    ymax = min(ymax, h - 1)
    half = _XY_ONE >> 1
    # two edges walk down from the top vertex, one each way round
    e_idx, e_di = [imin, imin], [1, npts - 1]
    e_x, e_dx, e_ye = [-_XY_ONE, -_XY_ONE], [0, 0], [ymin, ymin]
    edges = npts
    y = ymin
    while True:
        for i in range(2):
            if y >= e_ye[i]:
                idx0 = e_idx[i]
                idx = (idx0 + e_di[i]) % npts
                while True:
                    edges -= 1
                    if edges < 0:
                        break
                    ty = v[idx][1]
                    if ty > y:
                        xs = v[idx0][0] << _XY_SHIFT
                        xe = v[idx][0] << _XY_SHIFT
                        e_ye[i] = ty
                        e_dx[i] = _trunc_div((xe - xs) * 2 + (ty - y),
                                             2 * (ty - y))
                        e_x[i] = xs
                        e_idx[i] = idx
                        break
                    idx0 = idx
                    idx = (idx + e_di[i]) % npts
        if edges < 0:
            break
        if y >= 0:
            left, right = (1, 0) if e_x[0] > e_x[1] else (0, 1)
            xx1 = (e_x[left] + half) >> _XY_SHIFT
            xx2 = (e_x[right] + half) >> _XY_SHIFT
            if xx2 >= 0 and xx1 < w:
                _hline(img, y, max(xx1, 0), min(xx2, w - 1), color)
        e_x[0] += e_dx[0]
        e_x[1] += e_dx[1]
        y += 1
        if y > ymax:
            break
    return img


def circle(img: np.ndarray, center: Tuple[int, int], radius: int,
           color) -> np.ndarray:
    """``cv2.circle(img, center, radius, color, thickness=-1)`` in place
    (the filled midpoint circle of cv2's ``Circle``); returns ``img``."""
    h, w = img.shape[:2]
    color = np.asarray(color, img.dtype)[:img.shape[2] if img.ndim == 3
                                         else 1]
    cx, cy = int(center[0]), int(center[1])
    err, dx, dy, plus, minus = 0, radius, 0, 1, (radius << 1) - 1
    while dx >= dy:
        for row, x1, x2 in ((cy - dy, cx - dx, cx + dx),
                            (cy + dy, cx - dx, cx + dx),
                            (cy - dx, cx - dy, cx + dy),
                            (cy + dx, cx - dy, cx + dy)):
            if 0 <= row < h and x1 < w and x2 >= 0:
                _hline(img, row, max(x1, 0), min(x2, w - 1), color)
        dy += 1
        err += plus
        plus += 2
        mask = 0 if err <= 0 else -1
        err -= minus & mask
        dx += mask
        minus -= mask & 2
    return img


def add_weighted(a: np.ndarray, alpha: float, b: np.ndarray, beta: float,
                 gamma: float = 0.0) -> np.ndarray:
    """``cv2.addWeighted(a, alpha, b, beta, gamma)`` on uint8: the float
    weights, rounded half to even, saturated."""
    v = (a.astype(np.float64) * np.float32(alpha)
         + b.astype(np.float64) * np.float32(beta) + np.float32(gamma))
    return np.clip(np.rint(v), 0, 255).astype(np.uint8)
