"""InstantID support: face-keypoint condition images and identity tokens
(port of ``omg_tpu/instantid.py``).

``draw_kps`` renders the IdentityNet's condition image in numpy (no cv2);
``encode_face_tokens`` runs the resampler on an ArcFace embedding. The
face analysis itself (detection and the 512-d ArcFace embedding) is
insightface's ONNX stack in the reference, which the port does not call:
callers pass the embeddings and a keypoint image (or a
``face_kps_provider``) to ``OMG.generate``, as the JAX signature allows.
"""

from __future__ import annotations

import math
from typing import Protocol, Sequence

import numpy as np
import torch

from omg_tpu_torch.models.resampler import Resampler
from omg_tpu_torch.nn import layers
from omg_tpu_torch.utils import profiling

# 5-keypoint face skeleton: eyes, nose, mouth corners; every limb ends at
# the nose (index 2).
KPS_COLORS = ((255, 0, 0), (0, 255, 0), (0, 0, 255),
              (255, 255, 0), (255, 0, 255))
_LIMBS = ((0, 2), (1, 2), (3, 2), (4, 2))
_STICKWIDTH = 4
_POINT_RADIUS = 10

_NO_INSIGHTFACE = ("insightface is not installed: pass precomputed "
                   "face_embeddings/face_kps in the request, or inject "
                   "face_provider=... into OMGServer")


def _fill_rotated_ellipse(img: np.ndarray, cx: float, cy: float,
                          a: float, b: float, angle_rad: float,
                          color: Sequence[int]) -> None:
    h, w = img.shape[:2]
    y0 = max(0, int(cy - a - b - 2))
    y1 = min(h, int(cy + a + b + 3))
    x0 = max(0, int(cx - a - b - 2))
    x1 = min(w, int(cx + a + b + 3))
    if y0 >= y1 or x0 >= x1:
        return
    yy, xx = np.mgrid[y0:y1, x0:x1]
    dx = xx - cx
    dy = yy - cy
    c, s = math.cos(angle_rad), math.sin(angle_rad)
    u = dx * c + dy * s
    v = -dx * s + dy * c
    inside = (u / max(a, 1e-6)) ** 2 + (v / max(b, 1e-6)) ** 2 <= 1.0
    img[y0:y1, x0:x1][inside] = color


def draw_kps(height: int, width: int,
             kps_list: Sequence[np.ndarray]) -> np.ndarray:
    """Face keypoints -> IdentityNet condition image, uint8 [H, W, 3].
    ``kps_list``: one [5, 2] (x, y) array per face."""
    out = np.zeros((height, width, 3), np.float32)
    for kps in kps_list:
        kps = np.asarray(kps, np.float32)
        for p, q in _LIMBS:
            color = np.asarray(KPS_COLORS[p], np.float32) * 0.6
            x0, y0 = kps[p]
            x1, y1 = kps[q]
            length = math.hypot(x1 - x0, y1 - y0)
            angle = math.atan2(y0 - y1, x0 - x1)
            _fill_rotated_ellipse(out, (x0 + x1) / 2, (y0 + y1) / 2,
                                  length / 2, _STICKWIDTH, angle, color)
    for kps in kps_list:
        kps = np.asarray(kps, np.float32)
        for idx, (x, y) in enumerate(kps):
            _fill_rotated_ellipse(out, x, y, _POINT_RADIUS, _POINT_RADIUS,
                                  0.0, KPS_COLORS[idx])
    return out.astype(np.uint8)


def kps_image_to_cond(img: np.ndarray, device="cuda") -> torch.Tensor:
    """uint8 [H, W, 3] -> [1, H, W, 3] float32 in [0, 1] on ``device``, the
    card unless the caller asks for the CPU (diffusers' ControlNet
    conditioning normalization)."""
    device = layers.target_device(device, "kps_image_to_cond")
    return profiling.sync(torch.as_tensor, np.asarray(img, np.float32),
                          device=device)[None] / 255.0


class FaceEmbedder(Protocol):
    """Host-side identity embedding provider: any callable giving
    (kps [5, 2], arcface [512]) per detected face, e.g. precomputed
    fixtures."""

    def __call__(self, image: np.ndarray) -> Sequence[tuple]:
        ...


def face_region_box(kps: np.ndarray, image_hw: tuple,
                    expand: float = 1.6, body_factor: float = 4.0
                    ) -> np.ndarray:
    """Person-region box [x0, y0, x1, y1] from 5-point face keypoints: the
    face span widened ``expand``x horizontally and extended
    ``body_factor`` face heights downward, clipped to the image. A
    detector-free region prior to prompt SAM with."""
    kps = np.asarray(kps, np.float32)
    h, w = image_hw
    x0, y0 = kps[:, 0].min(), kps[:, 1].min()
    x1, y1 = kps[:, 0].max(), kps[:, 1].max()
    cx = (x0 + x1) / 2
    face_w = max(x1 - x0, 1.0)
    face_h = max(y1 - y0, 1.0)
    half_w = face_w * expand
    top = y0 - face_h * 1.0
    bottom = y1 + face_h * body_factor
    return np.array([max(0.0, cx - half_w), max(0.0, top),
                     min(float(w), cx + half_w), min(float(h), bottom)],
                    np.float32)


def make_kps_box_provider(faces_kps):
    """box_provider(image, text) -> the region box of the next concept's
    face keypoints, cycling (concept order == rewrite region order)."""
    state = {"i": 0}

    def provider(image, text):
        if not faces_kps:
            return None
        kps = faces_kps[state["i"] % len(faces_kps)]
        state["i"] += 1
        if kps is None:
            return None
        return face_region_box(kps, image.shape[:2])

    return provider


def encode_face_tokens(resampler: Resampler,
                       embedding: torch.Tensor) -> torch.Tensor:
    """ArcFace embedding [E] (or [N, E]) -> CFG-stacked image-prompt
    tokens [2, num_queries, output_dim].

    Row 0 is the unconditional branch: the resampler applied to a zeros
    embedding, not zero tokens."""
    emb = profiling.sync(torch.as_tensor, embedding, dtype=torch.float32,
                         device=resampler.latents.device)
    emb = emb.reshape(1, -1, resampler.cfg.embedding_dim)
    return resampler(torch.cat([torch.zeros_like(emb), emb]))


def analyze_faces(image_rgb: np.ndarray):
    """The reference's insightface detection; not called by the port."""
    raise RuntimeError(_NO_INSIGHTFACE)


def stage1_kps_provider(image_rgb: np.ndarray):
    """The reference's default ``face_kps_provider`` (insightface on the
    stage-1 image); not called by the port."""
    raise RuntimeError(_NO_INSIGHTFACE)


def analyze_face(image_rgb: np.ndarray):
    """The reference's largest-face insightface analysis; not called by
    the port."""
    raise RuntimeError(_NO_INSIGHTFACE)
