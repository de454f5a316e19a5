"""Synthetic-composite evaluation for the open-vocabulary detector (port
of ``omg_tpu/segment/detector_eval.py``; numpy only).

It composes scenes with known geometry (textured subjects at known
ground-truth masks on cluttered backgrounds, plus distractor shapes),
runs the FULL propose -> rank -> assign path, and scores:

  * mean mask-IoU over present classes (a miss counts 0),
  * class-assignment accuracy (present class correct iff its predicted
    mask IoU >= 0.5; absent class correct iff the detector returns
    None),
  * distractor rejection (no distractor region assigned to a class).

``build_synthetic_detector()`` wires a weight-free colour-component
proposer with boundary noise and a chroma-prototype scorer into the
port's ``OpenVocabDetector``: the greedy assignment, overlap veto,
caching, crop geometry and mask bookkeeping under test are the
production code paths.

Run ``python -m omg_tpu_torch.segment.detector_eval`` to print (and, with
--out, record) the score.
"""

from __future__ import annotations

from collections import deque
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from omg_tpu_torch.segment.detector import (OpenVocabDetector, Proposal,
                                           _bbox_of)

# class -> signature RGB (subjects are textured around these). "red" and
# "orange" are deliberately close in chroma: ranking, not thresholding,
# must separate them (the reference detectors face the same person-vs-
# person ambiguity).
CLASS_COLORS: Dict[str, Tuple[int, int, int]] = {
    "red object": (200, 40, 40),
    "blue object": (40, 60, 200),
    "green object": (40, 180, 60),
    "orange object": (230, 140, 30),
}
# distractor palette: low-chroma shapes a color-prototype scorer must
# reject (and real CLIP scores low against any color word)
DISTRACTOR_COLORS = ((235, 235, 235), (25, 25, 25), (128, 128, 128))


# --------------------------------------------------------------------------
# Composite generation
# --------------------------------------------------------------------------

def _ellipse_mask(h: int, w: int, cy: float, cx: float, ry: float,
                  rx: float, angle: float) -> np.ndarray:
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
    ys, xs = ys - cy, xs - cx
    c, s = np.cos(angle), np.sin(angle)
    u = (c * xs + s * ys) / rx
    v = (-s * xs + c * ys) / ry
    return u * u + v * v <= 1.0


def make_composite(seed: int, classes: Sequence[str], *, h: int = 96,
                   w: int = 144, n_distractors: int = 3,
                   max_overlap_iou: float = 0.15):
    """-> (image uint8 [h,w,3], {cls: gt bool mask}) — one textured
    subject per class at a known mask, on a gradient+noise background
    with low-chroma distractor shapes."""
    rng = np.random.RandomState(seed)
    # background: smooth two-way gradient + grain (keeps a naive
    # global-threshold proposer honest)
    gy = np.linspace(90, 150, h, dtype=np.float32)[:, None]
    gx = np.linspace(-20, 20, w, dtype=np.float32)[None, :]
    img = np.repeat((gy + gx)[..., None], 3, axis=2)
    img += rng.normal(0, 6, img.shape)

    def place(avoid: List[np.ndarray]) -> np.ndarray:
        for _ in range(200):
            ry = rng.uniform(h / 9, h / 4.5)
            rx = rng.uniform(w / 12, w / 6)
            cy = rng.uniform(ry + 2, h - ry - 2)
            cx = rng.uniform(rx + 2, w - rx - 2)
            m = _ellipse_mask(h, w, cy, cx, ry, rx,
                              rng.uniform(0, np.pi))
            ok = True
            for other in avoid:
                inter = float(np.logical_and(m, other).sum())
                union = float(np.logical_or(m, other).sum())
                if inter / max(union, 1.0) > max_overlap_iou:
                    ok = False
                    break
            if ok:
                return m
        raise RuntimeError("could not place a non-overlapping subject")

    placed: List[np.ndarray] = []
    gt: Dict[str, np.ndarray] = {}
    for cls in classes:
        m = place(placed)
        placed.append(m)
        gt[cls] = m
        color = np.asarray(CLASS_COLORS[cls], np.float32)
        tex = color[None, None] + rng.normal(0, 12, (h, w, 3))
        img = np.where(m[..., None], tex, img)
    for k in range(n_distractors):
        m = place(placed)
        placed.append(m)
        color = np.asarray(
            DISTRACTOR_COLORS[k % len(DISTRACTOR_COLORS)], np.float32)
        tex = color[None, None] + rng.normal(0, 12, (h, w, 3))
        img = np.where(m[..., None], tex, img)
    return np.clip(img, 0, 255).astype(np.uint8), gt


# --------------------------------------------------------------------------
# Weight-free stand-ins for the SAM proposer and CLIP scorer
# --------------------------------------------------------------------------

def _connected_components(binary: np.ndarray) -> List[np.ndarray]:
    """4-connected components of a bool map (pure numpy/python BFS —
    composites are small)."""
    h, w = binary.shape
    seen = np.zeros((h, w), bool)
    comps = []
    for sy, sx in zip(*np.nonzero(binary)):
        if seen[sy, sx]:
            continue
        q = deque([(sy, sx)])
        seen[sy, sx] = True
        pix = []
        while q:
            y, x = q.popleft()
            pix.append((y, x))
            for ny, nx in ((y - 1, x), (y + 1, x), (y, x - 1), (y, x + 1)):
                if (0 <= ny < h and 0 <= nx < w and binary[ny, nx]
                        and not seen[ny, nx]):
                    seen[ny, nx] = True
                    q.append((ny, nx))
        m = np.zeros((h, w), bool)
        ys, xs = zip(*pix)
        m[list(ys), list(xs)] = True
        comps.append(m)
    return comps


def _jitter_mask(mask: np.ndarray, rng: np.random.RandomState,
                 p_flip: float = 0.25) -> np.ndarray:
    """Imperfect segmentation: flip a fraction of BOUNDARY pixels so
    proposal masks score IoU < 1 against ground truth (the metric must
    track quality, not exact-match plumbing)."""
    inner = mask.copy()
    inner[1:] &= mask[:-1]; inner[:-1] &= mask[1:]
    inner[:, 1:] &= mask[:, :-1]; inner[:, :-1] &= mask[:, 1:]
    outer = mask.copy()
    outer[1:] |= mask[:-1]; outer[:-1] |= mask[1:]
    outer[:, 1:] |= mask[:, :-1]; outer[:, :-1] |= mask[:, 1:]
    band = outer & ~inner
    flip = band & (rng.uniform(size=mask.shape) < p_flip)
    return mask ^ flip


def component_proposals(image: np.ndarray, *, seed: int = 0,
                        min_area_frac: float = 0.002,
                        max_area_frac: float = 0.5,
                        max_proposals: int = 24) -> List[Proposal]:
    """Class-agnostic proposals, boundaries jittered. Two passes so the
    pool contains subjects AND distractors (ranking must tell them
    apart): (1) chroma components split by hue octant — adjacent
    different-hue subjects become separate proposals, the failure a
    plain saliency threshold has; (2) distance-from-median-background
    components, which is what finds the LOW-chroma (gray/white/black)
    distractor shapes."""
    rng = np.random.RandomState(seed)
    f = image.astype(np.float32)
    area = image.shape[0] * image.shape[1]
    out: List[Proposal] = []

    def admit(comp: np.ndarray) -> None:
        a = comp.mean()
        if not (min_area_frac <= a <= max_area_frac):
            return
        if any(np.logical_and(comp, p.mask).sum()
               / max(np.logical_or(comp, p.mask).sum(), 1) > 0.7
               for p in out):
            return
        m = _jitter_mask(comp, rng)
        box = _bbox_of(m)
        if box is not None:
            out.append(Proposal(m, box, float(comp.sum()) / area))

    # pass 1: hue-binned chroma components (opponent-color coordinates)
    r, g, b = f[..., 0], f[..., 1], f[..., 2]
    cx = r - (g + b) / 2
    cy = (g - b) * (np.sqrt(3.0) / 2)
    strong = np.hypot(cx, cy) > 45.0
    # half-sector offset: bin CENTERS sit on the cardinal hues, so a
    # pure-red region (angle 0) doesn't straddle a bin edge and shatter
    # into interleaved fragments under pixel noise
    octant = np.floor((np.arctan2(cy, cx) + np.pi + np.pi / 8)
                      / (np.pi / 4)) % 8
    for k in np.unique(octant[strong]):
        for comp in _connected_components(strong & (octant == k)):
            if len(out) >= max_proposals:
                return out
            admit(comp)

    # pass 2: saliency vs the median (background) color
    med = np.median(f.reshape(-1, 3), axis=0)
    dist = np.linalg.norm(f - med[None, None], axis=-1)
    for thresh in (90.0, 60.0):
        for comp in _connected_components(dist > thresh):
            if len(out) >= max_proposals:
                return out
            admit(comp)
    return out


def chroma_embedders():
    """(embed_image, embed_texts) scoring crops against CLASS_COLORS by
    chroma-prototype cosine. Crop features keep their chroma MAGNITUDE
    (low-chroma distractor crops score near 0 against every class, the
    shape CLIP similarity takes for off-class crops); text prototypes
    are unit-norm."""
    def feat(rgb: np.ndarray) -> np.ndarray:
        r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
        return np.stack([r - g, g - b, b - r], -1) / 255.0

    def embed_image(crops_uint8: np.ndarray) -> np.ndarray:
        f = feat(crops_uint8.astype(np.float32))
        return f.reshape(f.shape[0], -1, 3).mean(axis=1)

    def embed_texts(texts: Sequence[str]) -> np.ndarray:
        protos = []
        for t in texts:
            c = np.asarray(CLASS_COLORS[t], np.float32)[None, None]
            v = feat(c).reshape(3)
            protos.append(v / max(np.linalg.norm(v), 1e-6))
        return np.stack(protos)

    return embed_image, embed_texts


def build_synthetic_detector(seed: int = 0, **det_kwargs) -> OpenVocabDetector:
    """The production OpenVocabDetector over the weight-free stages.
    sim_thresh is in the stub's chroma-cosine units (crop chroma is
    background-diluted; subjects land ~0.15-0.35, distractors < 0.05)."""
    embed_image, embed_texts = chroma_embedders()
    det_kwargs.setdefault("sim_thresh", 0.08)
    return OpenVocabDetector(
        lambda img: component_proposals(img, seed=seed),
        embed_image, embed_texts, **det_kwargs)


# --------------------------------------------------------------------------
# Scoring
# --------------------------------------------------------------------------

def _iou(a: Optional[np.ndarray], b: np.ndarray) -> float:
    if a is None:
        return 0.0
    a = np.asarray(a) > 0.5
    inter = float(np.logical_and(a, b).sum())
    return inter / max(float(np.logical_or(a, b).sum()), 1.0)


def evaluate(detector, cases: Sequence[tuple], *,
             query_absent: Sequence[str] = ()) -> dict:
    """cases: [(image, {cls: gt_mask})]. Runs detector.masks_for over
    each case's present classes (+ ``query_absent`` classes that must
    come back None) and aggregates mask-IoU / assignment accuracy."""
    ious, correct, total = [], 0, 0
    absent_correct, absent_total = 0, 0
    per_case = []
    for image, gt in cases:
        present = list(gt)
        queried = present + [c for c in query_absent if c not in present]
        masks = detector.masks_for(image, queried)
        rec = {}
        for cls, m in zip(queried, masks):
            if cls in gt:
                iou = _iou(m, gt[cls])
                ious.append(iou)
                correct += iou >= 0.5
                total += 1
                rec[cls] = round(iou, 4)
            else:
                absent_correct += m is None
                absent_total += 1
                rec[cls] = None if m is None else "FALSE_POSITIVE"
        per_case.append(rec)
    out = {
        "n_cases": len(per_case),
        "present_queries": total,
        "mean_mask_iou": round(float(np.mean(ious)) if ious else 0.0, 4),
        "assignment_accuracy": round(correct / max(total, 1), 4),
        "per_case": per_case,
    }
    if absent_total:
        out["absent_queries"] = absent_total
        out["absent_rejection_rate"] = round(
            absent_correct / absent_total, 4)
    return out


def build_cases(n_cases: int, *, seed: int = 0, h: int = 96,
                w: int = 144) -> tuple:
    """The canonical case recipe (the JAX package's real-weights
    validation scores the same one): randomized composites with 2-3
    subjects each (rotating class subsets, 3 distractors) plus one absent
    class per case. -> (cases [(image, gt)], absents [cls])."""
    all_classes = list(CLASS_COLORS)
    cases, absents = [], []
    for i in range(n_cases):
        k = 2 + (i % 2)
        rot = [all_classes[(i + j) % len(all_classes)] for j in range(k)]
        cases.append(make_composite(seed + 1000 + i, rot, h=h, w=w))
        absents.append(all_classes[(i + k) % len(all_classes)])
    return cases, absents


def run_ci_eval(n_cases: int = 12, seed: int = 0) -> dict:
    """The tracked zero-egress score: build_cases() composites, fresh
    detector per case (the per-image cache is separately tested)."""
    cases, absents = build_cases(n_cases, seed=seed)
    # query one absent class per case: evaluate() queries the union, so
    # run per-case with its own absent class
    agg = {"n_cases": 0, "present_queries": 0, "mean_mask_iou": 0.0,
           "assignment_accuracy": 0.0, "absent_queries": 0,
           "absent_rejection_rate": 0.0, "per_case": []}
    ious_w, acc_w, abs_w = [], [], []
    for (case, absent) in zip(cases, absents):
        det = build_synthetic_detector(seed)
        r = evaluate(det, [case], query_absent=[absent])
        agg["n_cases"] += 1
        agg["present_queries"] += r["present_queries"]
        agg["absent_queries"] += r.get("absent_queries", 0)
        ious_w += [r["mean_mask_iou"]] * r["present_queries"]
        acc_w += [r["assignment_accuracy"]] * r["present_queries"]
        abs_w += [r.get("absent_rejection_rate", 1.0)]
        agg["per_case"] += r["per_case"]
    agg["mean_mask_iou"] = round(float(np.mean(ious_w)), 4)
    agg["assignment_accuracy"] = round(float(np.mean(acc_w)), 4)
    agg["absent_rejection_rate"] = round(float(np.mean(abs_w)), 4)
    agg["what"] = ("synthetic-composite detector eval (weight-free "
                   "proposer/scorer through the production "
                   "OpenVocabDetector assign path)")
    return agg


def main(argv=None):
    import argparse
    import json
    p = argparse.ArgumentParser("omg detector synthetic eval")
    p.add_argument("--n_cases", type=int, default=12)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", default="")
    args = p.parse_args(argv)
    rec = run_ci_eval(args.n_cases, args.seed)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rec, f, indent=1)
            f.write("\n")
    print(json.dumps({k: v for k, v in rec.items() if k != "per_case"},
                     indent=2))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
