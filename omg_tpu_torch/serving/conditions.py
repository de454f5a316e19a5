"""Spatial-condition preprocessing for serving (port of
``omg_tpu/serving/conditions.py``).

A user's photo becomes a ControlNet condition: Canny edges, or a pose or
depth map from a provider (without one, the photo passes through as a
precomputed map). The generation size snaps to the SDXL aspect bucket
closest to the request's; nine buckets bound the server's programs.

The JAX module calls PIL (the Lanczos resize) and cv2 (Canny), which the
GPU host lacks. ``resize_and_center_crop`` runs PIL's own fixed-point
Lanczos passes (``utils/image.resize``), bit for bit. ``canny`` is
``cv2.Canny(image, low, high)`` in numpy: 3x3 Sobel per channel with
replicated borders, per pixel the channel of largest L1 gradient (cv2's
rule for colour input), cv2's integer non-maximum suppression
(tan 22.5° in 15-bit fixed point, its strict/non-strict neighbour tests),
then hysteresis from the pixels above ``high`` through the candidates
above ``low`` (8-connected).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from omg_tpu_torch.utils import image as image_lib

# The nine SDXL training aspect buckets (height, width).
RESOLUTIONS = [
    (1024, 1024), (1152, 896), (896, 1152), (1216, 832), (832, 1216),
    (1344, 768), (768, 1344), (1536, 640), (640, 1536),
]


def snap_resolution(height: int, width: int) -> Tuple[int, int]:
    """Closest bucket by aspect ratio."""
    ratio = width / height
    return min(RESOLUTIONS, key=lambda hw: abs(hw[1] / hw[0] - ratio))


def resize_and_center_crop(image: np.ndarray, height: int,
                           width: int) -> np.ndarray:
    """Cover-fit a uint8 [H, W, C] image into (height, width): PIL's
    Lanczos resize to cover, then the centre crop."""
    h, w = image.shape[:2]
    scale = max(height / h, width / w)
    nh, nw = round(h * scale), round(w * scale)
    img = image_lib.resize(image, nh, nw, filt="lanczos")
    top = (nh - height) // 2
    left = (nw - width) // 2
    return img[top:top + height, left:left + width]


_CANNY_SHIFT = 15
_TG22 = int(0.4142135623730950488016887242097 * (1 << _CANNY_SHIFT) + 0.5)


def _sobel(x: np.ndarray) -> tuple:
    """3x3 Sobel (dx, dy) of int [H, W, C] with replicated borders."""
    p = np.pad(x, ((1, 1), (1, 1), (0, 0)), mode="edge")
    h, w = x.shape[:2]

    def at(dy, dx):
        return p[1 + dy:1 + dy + h, 1 + dx:1 + dx + w]
    gx = (at(-1, 1) + 2 * at(0, 1) + at(1, 1)
          - at(-1, -1) - 2 * at(0, -1) - at(1, -1))
    gy = (at(1, -1) + 2 * at(1, 0) + at(1, 1)
          - at(-1, -1) - 2 * at(-1, 0) - at(-1, 1))
    return gx, gy


def canny(image: np.ndarray, low: int = 100, high: int = 200) -> np.ndarray:
    """The Canny edge condition of a uint8 [H, W] or [H, W, C] image ->
    the 3-channel uint8 map (edges 255), as ``cv2.Canny(image, low,
    high)`` with its default aperture 3 and L1 gradient."""
    x = np.asarray(image).astype(np.int64)
    if x.ndim == 2:
        x = x[:, :, None]
    if low > high:
        low, high = high, low
    gx, gy = _sobel(x)
    mag = np.abs(gx) + np.abs(gy)
    pick = np.argmax(mag, axis=2)[:, :, None]        # first largest channel
    gx, gy, mag = (np.take_along_axis(a, pick, 2)[:, :, 0]
                   for a in (gx, gy, mag))
    h, w = mag.shape
    mp = np.pad(mag, 1)                               # zero border

    def nb(dy, dx):
        return mp[1 + dy:1 + dy + h, 1 + dx:1 + dx + w]
    ax = np.abs(gx)
    ay = np.abs(gy) << _CANNY_SHIFT
    tg22x = ax * _TG22
    tg67x = tg22x + (ax << (_CANNY_SHIFT + 1))
    horiz = ay < tg22x
    vert = ~horiz & (ay > tg67x)
    diag = ~horiz & ~vert
    s = np.where((gx ^ gy) < 0, -1, 1)
    keep = np.where(horiz, (mag > nb(0, -1)) & (mag >= nb(0, 1)),
                    np.where(vert, (mag > nb(-1, 0)) & (mag >= nb(1, 0)),
                             False))
    # the diagonal neighbours (-1, -s) and (1, s), s = +-1 per pixel
    d_pos = (mag > nb(-1, -1)) & (mag > nb(1, 1))
    d_neg = (mag > nb(-1, 1)) & (mag > nb(1, -1))
    keep |= diag & np.where(s > 0, d_pos, d_neg)
    keep &= mag > low
    strong = keep & (mag > high)
    # hysteresis: grow the strong pixels through the kept ones
    wp = w + 2
    cand = np.pad(keep, 1).ravel()
    edge = np.pad(strong, 1).ravel()
    offsets = np.array([-wp - 1, -wp, -wp + 1, -1, 1, wp - 1, wp, wp + 1])
    front = np.flatnonzero(edge)
    while front.size:
        n = (front[:, None] + offsets).ravel()
        n = np.unique(n[cand[n] & ~edge[n]])
        edge[n] = True
        front = n
    edges = edge.reshape(h + 2, wp)[1:-1, 1:-1].astype(np.uint8) * 255
    return np.stack([edges] * 3, axis=-1)


# The reference UI's condition labels -> canonical kinds.
_KINDS = {"human pose": "pose", "canny edge": "canny", "depth": "depth",
          "pose": "pose", "canny": "canny"}


def condition_kind(kind: Optional[str]) -> Optional[str]:
    if kind in (None, "", "None"):
        return None
    return _KINDS.get(kind.strip().lower(), kind.strip().lower())


def prepare_condition(image: Optional[np.ndarray], kind: str,
                      height: int, width: int, *,
                      pose_provider=None,
                      depth_provider=None) -> Optional[np.ndarray]:
    """Photo -> ControlNet condition map at (height, width).

    ``kind`` in {None, 'canny', 'pose', 'depth'} or the reference UI's
    labels ('Human pose', 'Canny Edge', 'Depth'): canny edges;
    ``pose_provider(photo)`` -> a skeleton map; ``depth_provider(photo,
    (height, width))`` -> an inverse-depth map. Without a provider a pose
    or depth image passes through as a precomputed map."""
    kind = condition_kind(kind)
    if image is None or kind is None:
        return None
    image = resize_and_center_crop(image, height, width)
    if kind == "canny":
        return canny(image)
    if kind == "pose" and pose_provider is not None:
        return np.asarray(pose_provider(image))
    if kind == "depth" and depth_provider is not None:
        return np.asarray(depth_provider(image, (height, width)))
    return image
