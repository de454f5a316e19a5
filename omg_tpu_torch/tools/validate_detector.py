"""Checkpoint-gated validation of the open-vocabulary detector (port of
``tools/validate_detector.py``).

The detector (``segment/detector.py``) carries the most judgment-bound
settings of the mask stage (``sim_thresh`` 0.18, grid 8, the NMS and
area bounds), and its weights never load where there are no checkpoints.
Given SAM and CLIP checkpoints and a CLIP tokenizer folder, this runs the
SAM x CLIP detector on photos (the reference repository's ``example/``
folder, or any images named), and reports per image the proposals, each
class's box with its similarity and mask area, the cross-class box IoU
against the overlap veto, and a ``sim_thresh`` sweep, so that the default
can be tuned on real data; ``--composites N`` adds the synthetic
composite IoU/accuracy evaluation (``segment/detector_eval.py``) with the
real detector.

    python -m omg_tpu_torch.tools.validate_detector \\
        --sam_checkpoint ./checkpoint/sam/xl1.pt \\
        --clip_checkpoint ./checkpoint/clip-vit-base-patch32/model.safetensors \\
        --tokenizer_dir ./checkpoint/stable-diffusion-xl-base-1.0/tokenizer \\
        --images_dir ./example --classes man,woman [--device cpu]

A missing checkpoint, tokenizer folder or image set prints ``SKIP: ...``
and exits 0. The models run on the card unless ``--device cpu``; images
are read as PNG or baseline JPEG (``utils/image.read_rgb``).
"""

from __future__ import annotations

import argparse
import glob
import json
import os

import numpy as np

from omg_tpu_torch import config as cfglib
from omg_tpu_torch import convert
from omg_tpu_torch.nn import layers
from omg_tpu_torch.segment.detector import build_openvocab_detector
from omg_tpu_torch.segment.sam_provider import convert_sam_checkpoint
from omg_tpu_torch.text.tokenizer import HFCLIPTokenizer
from omg_tpu_torch.utils import image as image_io


def parse_args(argv=None):
    p = argparse.ArgumentParser("omg_tpu_torch.tools.validate_detector",
                                description=__doc__.split("\n\n")[0])
    p.add_argument("--sam_checkpoint", default="./checkpoint/sam/xl1.pt")
    p.add_argument("--clip_checkpoint", default="")
    p.add_argument("--clip_text_checkpoint", default="")
    p.add_argument("--tokenizer_dir", default="")
    p.add_argument("--images_dir", default="./example",
                   help="folder of .jpg/.jpeg/.png photos (the reference "
                        "repository's example/)")
    p.add_argument("--images", default="",
                   help="comma-separated image paths (overrides "
                        "--images_dir)")
    p.add_argument("--classes", default="man,woman")
    p.add_argument("--grid", type=int, default=8)
    p.add_argument("--sim_thresh", type=float, default=0.18)
    p.add_argument("--sweep", default="0.12,0.15,0.18,0.22,0.26,0.30")
    p.add_argument("--composites", type=int, default=0,
                   help="also run the synthetic-composite IoU/accuracy "
                        "eval (segment/detector_eval.py) with the real "
                        "SAM+CLIP detector on N color-word composites")
    p.add_argument("--out", default="detector_report.json")
    p.add_argument("--device", default="cuda",
                   help="device of the models: cuda (default) or cpu")
    return p.parse_args(argv)


def build(args, device):
    """The SAM x CLIP detector from the files ``args`` names: SAM through
    the port's converter (EfficientViT-SAM or SAM ViT), the CLIP ViT-B/32
    towers (the text tower from ``--clip_text_checkpoint`` when given)
    and the tokenizer folder."""
    sam = convert_sam_checkpoint(args.sam_checkpoint, device=device)
    vision = convert.convert_clip_vision(
        args.clip_checkpoint, cfglib.clip_vit_b32_vision(), device=device)
    text = convert.convert_clip(
        args.clip_text_checkpoint or args.clip_checkpoint,
        cfglib.clip_vit_b32_text(), device=device)
    return build_openvocab_detector(
        sam, clip_vision=vision, clip_text=text,
        tokenizer=HFCLIPTokenizer(args.tokenizer_dir), grid=args.grid,
        sim_thresh=args.sim_thresh)


def validate_image(det, image: np.ndarray, classes: list,
                   sweep: list) -> dict:
    """One image's record: proposals, per-class boxes, the overlap veto's
    check and the ``sim_thresh`` sweep on the cached proposals; the
    detector's threshold and assignments are restored afterwards."""
    h, w = image.shape[:2]
    rec: dict = {"size": [h, w]}

    det._prepare(image)
    rec["n_proposals"] = len(det._proposals)
    rec["proposal_scores"] = [round(p.score, 3) for p in det._proposals]
    rec["proposal_area_frac"] = [
        round(float(p.mask.mean()), 4) for p in det._proposals]

    boxes = {}
    for cls in classes:
        box = det(image, cls)
        if box is None:
            boxes[cls] = None
            continue
        idx = det._assigned_indices[cls]
        sims = det._crop_embeds @ det._text_embed(cls)
        boxes[cls] = {
            "box_xyxy": [round(float(v), 1) for v in box],
            "similarity": round(float(sims[idx]), 4),
            "mask_area_frac": round(float(det._proposals[idx].mask.mean()),
                                    4),
        }
    rec["per_class"] = boxes

    # disjointness: assigned boxes must respect the overlap veto
    live = [(c, np.asarray(b["box_xyxy"], np.float32))
            for c, b in boxes.items() if b is not None]
    overlaps = {}
    for i in range(len(live)):
        for j in range(i + 1, len(live)):
            iou = det._box_iou(live[i][1], live[j][1])
            overlaps[f"{live[i][0]}|{live[j][0]}"] = round(float(iou), 4)
            if iou > det.overlap_thresh:
                rec["overlap_violation"] = True
    rec["cross_class_box_iou"] = overlaps

    # the sweep on the cached proposals and embeddings: which thresholds
    # still detect each class on this image
    sweep_hits = {}
    saved = det.sim_thresh
    try:
        for thr in sweep:
            det.sim_thresh = thr
            det._assigned, det._assigned_indices = {}, {}
            sweep_hits[str(thr)] = {
                cls: det(image, cls) is not None for cls in classes}
    finally:
        det.sim_thresh = saved
        det._assigned, det._assigned_indices = {}, {}
    rec["sim_thresh_sweep"] = sweep_hits
    return rec


def main(argv=None) -> int:
    args = parse_args(argv)
    missing = [n for n, v in (("--sam_checkpoint", args.sam_checkpoint),
                              ("--clip_checkpoint", args.clip_checkpoint),
                              ("--tokenizer_dir", args.tokenizer_dir))
               if not v or not os.path.exists(v)]
    if missing:
        print(f"SKIP: missing checkpoints/inputs: {', '.join(missing)} "
              "(this validation needs real checkpoints)")
        return 0

    if args.images:
        paths = [s for s in args.images.split(",") if s]
    else:
        paths = sorted(
            q for pat in ("*.jpg", "*.jpeg", "*.png")
            for q in glob.glob(os.path.join(args.images_dir, pat)))
    if not paths:
        print(f"SKIP: no images under {args.images_dir}")
        return 0

    device = layers.target_device(args.device, "validate_detector")
    det = build(args, device)
    classes = [c for c in args.classes.split(",") if c]
    sweep = [float(s) for s in args.sweep.split(",") if s]

    report = {"config": dict(vars(args)), "images": {}}
    for path in paths:
        report["images"][os.path.basename(path)] = validate_image(
            det, image_io.read_rgb(path), classes, sweep)

    # per-class hit rate at each swept threshold
    agg = {}
    for thr in sweep:
        hits = {c: 0 for c in classes}
        for rec in report["images"].values():
            for c in classes:
                if rec["sim_thresh_sweep"][str(thr)][c]:
                    hits[c] += 1
        agg[str(thr)] = {c: f"{hits[c]}/{len(paths)}" for c in classes}
    report["hit_rate_by_sim_thresh"] = agg
    report["overlap_violations"] = sum(
        1 for r in report["images"].values() if r.get("overlap_violation"))

    if args.composites > 0:
        # the tracked CI recipe with the real weights, at a resolution
        # where real CLIP crops are meaningful
        from omg_tpu_torch.segment import detector_eval as de
        cases, absents = de.build_cases(args.composites, h=256, w=384)
        comp = de.evaluate(det, cases, query_absent=sorted(set(absents)))
        report["composite_eval"] = comp
        print(json.dumps({k: v for k, v in comp.items()
                          if k != "per_case"}, indent=2))

    with open(args.out, "w") as f:
        json.dump(report, f, indent=2)
    print(json.dumps({"images": len(paths),
                      "hit_rate_by_sim_thresh": agg,
                      "overlap_violations": report["overlap_violations"],
                      "out": args.out}, indent=2))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
