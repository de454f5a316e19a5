"""``utils/cv.py`` against cv2, the library the JAX OpenPose module calls:
the cubic resize on uint8 (bit for bit against OpenCV's own code) and on
float maps (within 1e-5 of max |x|) at the estimator's scales and sizes;
the drawing primitives pixel for pixel; and ``draw_bodypose`` against the
JAX module's canvas on tests/test_preprocessors.py's two synthetic
people.

An OpenCV built with its IPP HAL (the opencv-python 5.0 wheel is) routes
INTER_CUBIC on uint8 through IPP when IPP is on (the default), which
rounds in float: it differs from OpenCV's own fixed-point code by one
level on a few per cent of the pixels. The port follows OpenCV's code,
so the exact comparison runs with IPP off, and the comparison with IPP on
holds the port within one level.
"""

import contextlib
import pathlib
import sys

import cv2
import numpy as np
import pytest
import torch

from omg_tpu.models import openpose as jop
from omg_tpu_torch.models import openpose
from omg_tpu_torch.utils import cv

from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse)

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
from test_preprocessors import _synthetic_person  # noqa: E402


@contextlib.contextmanager
def ipp(on: bool):
    saved = cv2.ipp.useIPP()
    cv2.ipp.setUseIPP(on)
    try:
        yield
    finally:
        cv2.ipp.setUseIPP(saved)


# (photo H, W): the estimator resizes by 0.5 * 368 / H
PHOTOS = [(1024, 1024), (1216, 832), (768, 1344), (80, 60), (7, 5)]


@pytest.mark.parametrize("shape", PHOTOS, ids=lambda s: f"{s[0]}x{s[1]}")
def test_resize_uint8_matches_opencv(shape):
    img = np.random.default_rng(sum(shape)).integers(
        0, 256, shape + (3,), dtype=np.uint8)
    for mult in (0.5 * 368 / shape[0], 0.7, 1.3, 2.0):
        with ipp(False):
            want = cv2.resize(img, (0, 0), fx=mult, fy=mult,
                              interpolation=cv2.INTER_CUBIC)
        got = cv.resize_cubic(img, fx=mult, fy=mult)
        np.testing.assert_array_equal(got, want, err_msg=str(mult))
        with ipp(True):
            ipp_out = cv2.resize(img, (0, 0), fx=mult, fy=mult,
                                 interpolation=cv2.INTER_CUBIC)
        assert np.abs(got.astype(int) - ipp_out.astype(int)).max() <= 1
    with ipp(False):
        want = cv2.resize(img[..., 0], (41, 29),
                          interpolation=cv2.INTER_CUBIC)
    np.testing.assert_array_equal(cv.resize_cubic(img[..., 0], (41, 29)),
                                  want)


@pytest.mark.parametrize("grid,photo", [((23, 23), (368, 368)),
                                        ((23, 16), (368, 256)),
                                        ((6, 8), (80, 60))],
                         ids=["1024-square", "1216x832", "tiny"])
def test_resize_float_maps_match_cv2(grid, photo):
    """The estimator's map path: 8x up, the crop to the scaled photo, then
    the resize to the photo (cv2 as the JAX module calls it)."""
    m = np.random.default_rng(1).standard_normal(grid + (19,)).astype(
        np.float32)
    up = cv2.resize(m, (0, 0), fx=8, fy=8, interpolation=cv2.INTER_CUBIC)
    crop = up[:grid[0] * 8 - 3, :grid[1] * 8 - 5]
    want = cv2.resize(crop, photo[::-1], interpolation=cv2.INTER_CUBIC)
    x = torch.from_numpy(m).permute(2, 0, 1)[None]
    got_up = cv.resize_cubic(x, fx=8, fy=8)
    got = cv.resize_cubic(got_up[:, :, :crop.shape[0], :crop.shape[1]],
                          photo[::-1])
    for g, w in ((got_up, up), (got, want)):
        g = g[0].permute(1, 2, 0).numpy()
        assert g.shape == w.shape
        assert np.abs(g - w).max() <= 1e-5 * np.abs(w).max()


def test_ellipse2poly_matches_cv2():
    rng = np.random.default_rng(0)
    for _ in range(600):
        center = (int(rng.integers(-20, 200)), int(rng.integers(-20, 200)))
        axes = (int(rng.integers(0, 80)), int(rng.integers(0, 10)))
        angle = int(rng.integers(-400, 400))
        start, end = (int(v) for v in rng.integers(-400, 400, 2))
        delta = int(rng.integers(1, 30))
        for arc in ((0, 360, 1), (start, end, delta)):
            np.testing.assert_array_equal(
                cv.ellipse2poly(center, axes, angle, *arc),
                cv2.ellipse2Poly(center, axes, angle, *arc))


def test_fill_convex_poly_matches_cv2():
    """OpenPose's limb sticks, inside and across the image edges."""
    rng = np.random.default_rng(1)
    for _ in range(400):
        poly = cv2.ellipse2Poly(
            (int(rng.integers(-20, 100)), int(rng.integers(-20, 80))),
            (int(rng.integers(0, 60)), 4), int(rng.integers(0, 360)),
            0, 360, 1)
        color = [int(v) for v in rng.integers(0, 256, 3)]
        want = np.zeros((60, 80, 3), np.uint8)
        cv2.fillConvexPoly(want, poly, color)
        got = cv.fill_convex_poly(np.zeros((60, 80, 3), np.uint8), poly,
                                  color)
        np.testing.assert_array_equal(got, want)


def test_circle_and_add_weighted_match_cv2():
    rng = np.random.default_rng(2)
    for _ in range(300):
        center = (int(rng.integers(-8, 58)), int(rng.integers(-8, 48)))
        radius = int(rng.integers(0, 12))
        want = np.zeros((40, 50, 3), np.uint8)
        cv2.circle(want, center, radius, [1, 2, 3], thickness=-1)
        got = cv.circle(np.zeros((40, 50, 3), np.uint8), center, radius,
                        [1, 2, 3])
        np.testing.assert_array_equal(got, want)
    a, b = (rng.integers(0, 256, (64, 64, 3), dtype=np.uint8)
            for _ in range(2))
    np.testing.assert_array_equal(cv.add_weighted(a, 0.4, b, 0.6, 0),
                                  cv2.addWeighted(a, 0.4, b, 0.6, 0))


def test_draw_bodypose_matches_jax():
    H, W = 96, 128
    heat = np.zeros((H, W, jop.HEAT_CH), np.float32)
    paf = np.zeros((H, W, jop.PAF_CH), np.float32)
    _synthetic_person(heat, paf, (30, 40), 0)
    _synthetic_person(heat, paf, (90, 40), 0)
    peaks = jop.find_peaks(heat)
    conn, special = jop.score_limbs(paf, peaks, H)
    candidate, subset = jop.assemble_people(peaks, conn, special)
    assert len(subset) == 2
    # the port's decode gives the same people
    t_peaks = openpose.find_peaks(heat)
    t_conn, t_special = openpose.score_limbs(paf, t_peaks, H)
    t_cand, t_sub = openpose.assemble_people(t_peaks, t_conn, t_special)
    np.testing.assert_array_equal(t_cand, candidate)
    np.testing.assert_array_equal(t_sub, subset)
    want = jop.draw_bodypose(np.zeros((H, W, 3), np.uint8), candidate,
                             subset)
    got = openpose.draw_bodypose(np.zeros((H, W, 3), np.uint8), candidate,
                                 subset)
    assert (want > 0).any()
    np.testing.assert_array_equal(got, want)
