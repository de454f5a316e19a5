"""Open-vocabulary per-concept detection: SAM proposals + CLIP ranking
(port of ``omg_tpu/segment/detector.py``).

The reference bridges stage 1 and stage 2 with an external open-vocabulary
detector giving one box per concept word (YOLO-World or GroundingDINO;
inference_lora.py:91-126). This detector composes models the port runs:

  1. proposals: SAM prompted with a point grid. Every grid point decodes
     3 candidate masks with a predicted IoU in one batched decoder call
     on the cached embedding; candidates are thresholded and deduplicated
     by mask-IoU NMS on the host.
  2. labelling: each proposal's padded square crop is scored against the
     class texts by CLIP image/text cosine similarity
     ("a photo of a {cls}", prompt-ensembled).
  3. assignment: greedy by score with an overlap veto, so two concepts
     never share a region.

Both stages are pluggable (``proposal_fn``, ``embed_image`` /
``embed_texts``), which keeps the unit tests weight-free.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from omg_tpu_torch.segment import evit_ops as ops
from omg_tpu_torch.segment import sam_decoder as dec

PROMPT_TEMPLATES = (
    "a photo of a {}",
    "a photo of the {}",
    "a cropped photo of a {}",
)


# --------------------------------------------------------------------------
# Proposal stage (SAM point grid)
# --------------------------------------------------------------------------

def _decode_point_grid(prompt: dec.PromptEncoder, decoder: dec.MaskDecoder,
                       embedding: torch.Tensor, points: torch.Tensor,
                       input_size: float) -> tuple:
    """points [B, 1, 2] -> (masks [B, 4, s, s], iou [B, 4]) in one batched
    decoder call; the embedding is broadcast, not copied."""
    b = points.shape[0]
    labels = points.new_ones(b, 1)
    sparse = dec.encode_points(prompt, points, labels, input_size)
    dense = dec.no_mask_dense(prompt, b, embedding.shape[1])
    emb = embedding.expand((b,) + embedding.shape[1:])
    return dec.decode_masks(decoder, prompt, emb, sparse, dense)


def _mask_iou(a: np.ndarray, b: np.ndarray) -> float:
    inter = np.logical_and(a, b).sum()
    union = np.logical_or(a, b).sum()
    return float(inter) / max(float(union), 1.0)


class Proposal:
    __slots__ = ("mask", "box", "score")

    def __init__(self, mask: np.ndarray, box: np.ndarray, score: float):
        self.mask = mask          # [H, W] bool at ORIGINAL image size
        self.box = box            # xyxy pixels at original size
        self.score = score        # SAM predicted IoU


def _bbox_of(mask: np.ndarray) -> Optional[np.ndarray]:
    ys, xs = np.nonzero(mask)
    if len(ys) == 0:
        return None
    return np.array([xs.min(), ys.min(), xs.max() + 1, ys.max() + 1],
                    np.float32)


def _nearest(mask: np.ndarray, size: tuple) -> np.ndarray:
    """PIL's NEAREST resize of a bool mask (pixel-centre sampling, torch's
    'nearest-exact'), on the host."""
    m = torch.from_numpy(mask.astype(np.float32))[None, None]
    m = F.interpolate(m, size=size, mode="nearest-exact")[0, 0]
    return m.numpy() > 0.5


class SamGridProposer:
    """Point-grid SAM proposal generator over a SamPredictor."""

    def __init__(self, predictor, *, grid: int = 8, iou_thresh: float = 0.7,
                 nms_thresh: float = 0.7, min_area_frac: float = 0.003,
                 max_area_frac: float = 0.95, max_proposals: int = 24):
        self.predictor = predictor
        self.grid = grid
        self.iou_thresh = iou_thresh
        self.nms_thresh = nms_thresh
        self.min_area_frac = min_area_frac
        self.max_area_frac = max_area_frac
        self.max_proposals = max_proposals

    def __call__(self, image: np.ndarray) -> List[Proposal]:
        pred = self.predictor
        pred.set_image(image)
        h, w = image.shape[:2]
        s = pred.cfg.image_size
        nh, nw = pred._input_size

        g = self.grid
        xs = (np.arange(g) + 0.5) / g * nw
        ys = (np.arange(g) + 0.5) / g * nh
        pts = np.stack(np.meshgrid(xs, ys, indexing="xy"), -1)
        masks, iou = _decode_point_grid(
            pred.sam.prompt_encoder, pred.sam.mask_decoder, pred._embedding,
            torch.as_tensor(pts.reshape(-1, 1, 2), dtype=torch.float32,
                            device=pred.device),
            float(s))
        # one transfer of all logits, then host-side selection
        masks = (masks > 0.0).cpu().numpy()     # [B, 4, ms, ms]
        iou = iou.float().cpu().numpy()

        ms = masks.shape[-1]
        # area bounds in the VALID (unpadded) region
        valid_frac = (nh / s) * (nw / s)
        cand = []
        for b in range(masks.shape[0]):
            for k in range(1, 4):       # multimask rows (predictor behavior)
                if iou[b, k] < self.iou_thresh:
                    continue
                m = masks[b, k]
                if not (self.min_area_frac * valid_frac <= m.mean()
                        <= self.max_area_frac * valid_frac):
                    continue
                cand.append((float(iou[b, k]), m))
        cand.sort(key=lambda t: -t[0])

        kept: List[tuple] = []
        for score, m in cand:
            if any(_mask_iou(m, km) > self.nms_thresh for _, km in kept):
                continue
            kept.append((score, m))
            if len(kept) >= self.max_proposals:
                break

        out = []
        mh, mw = int(round(nh / s * ms)), int(round(nw / s * ms))
        for score, m in kept:
            # low-res mask -> original pixel frame (undo pad + resize)
            m_full = _nearest(m[:mh, :mw], (h, w))
            box = _bbox_of(m_full)
            if box is not None:
                out.append(Proposal(m_full, box, score))
        return out


# --------------------------------------------------------------------------
# CLIP scoring stage
# --------------------------------------------------------------------------

def clip_embedders(vision, text, tokenizer) -> tuple:
    """-> (embed_image(crops_uint8) -> [B, D], embed_texts(strs) -> [T, D])
    as numpy, both L2-normalized, texts prompt-ensembled. ``vision`` is a
    ``CLIPVisionModel``, ``text`` a ``CLIPTextModel`` with a projection;
    each runs on its own device."""
    from omg_tpu_torch.models import clip_vision as cv

    def _unit(e: torch.Tensor) -> torch.Tensor:
        e = e.float()
        return e / e.norm(dim=-1, keepdim=True)

    def embed_image(crops_uint8: np.ndarray) -> np.ndarray:
        dev = vision.visual_projection.weight.device
        pix = cv.preprocess(crops_uint8, vision.cfg.image_size, dev)
        return _unit(vision(pix).projected).cpu().numpy()

    def embed_texts(texts: Sequence[str]) -> np.ndarray:
        dev = text.text_projection.weight.device
        embs = []
        for t in texts:
            ids = torch.as_tensor(
                tokenizer([tpl.format(t) for tpl in PROMPT_TEMPLATES]),
                dtype=torch.long, device=dev)
            e = _unit(text(ids).projected).cpu().numpy().mean(axis=0)
            embs.append(e / np.linalg.norm(e))
        return np.stack(embs)

    return embed_image, embed_texts


def _square_crop(image: np.ndarray, box: np.ndarray,
                 pad_frac: float = 0.1) -> np.ndarray:
    """Padded square crop around a box (CLIP sees some context)."""
    h, w = image.shape[:2]
    x0, y0, x1, y1 = box
    cx, cy = (x0 + x1) / 2, (y0 + y1) / 2
    side = max(x1 - x0, y1 - y0) * (1 + 2 * pad_frac)
    x0 = int(max(0, cx - side / 2))
    y0 = int(max(0, cy - side / 2))
    x1 = int(min(w, cx + side / 2))
    y1 = int(min(h, cy + side / 2))
    return image[y0:y1, x0:x1]


# --------------------------------------------------------------------------
# Detector
# --------------------------------------------------------------------------

class OpenVocabDetector:
    """box_provider-compatible detector: ``det(image, text) -> xyxy | None``.

    Proposals and crop embeddings are computed once per image (cached by
    content fingerprint) and scored against each class text on demand.
    Assignment is greedy by score with a pairwise box-IoU veto so concepts
    get disjoint regions. The crops are resized on the host, as PIL's
    bilinear does it."""

    def __init__(self, proposal_fn: Callable, embed_image: Callable,
                 embed_texts: Callable, *, sim_thresh: float = 0.18,
                 overlap_thresh: float = 0.5, crop_size: int = 224):
        self.proposal_fn = proposal_fn
        self.embed_image = embed_image
        self.embed_texts = embed_texts
        self.sim_thresh = sim_thresh
        self.overlap_thresh = overlap_thresh
        self.crop_size = crop_size
        self._cache_key = None
        self._proposals: List[Proposal] = []
        self._crop_embeds: Optional[np.ndarray] = None
        self._text_cache: dict = {}
        self._assigned: dict = {}
        self._assigned_indices: dict = {}

    # -- per-image computation -------------------------------------------

    def _prepare(self, image: np.ndarray) -> None:
        from omg_tpu_torch.segment import image_fingerprint
        key = image_fingerprint(image)   # content key: id() gets reused
        if key == self._cache_key:
            return
        self._cache_key = key
        self._assigned = {}
        self._assigned_indices = {}
        self._proposals = self.proposal_fn(image)
        if not self._proposals:
            self._crop_embeds = None
            return
        size = (self.crop_size, self.crop_size)
        crops = [ops.resize_uint8(_square_crop(image, p.box), size).numpy()
                 .astype(np.uint8) for p in self._proposals]
        self._crop_embeds = self.embed_image(np.stack(crops))

    def _text_embed(self, text: str) -> np.ndarray:
        if text not in self._text_cache:
            self._text_cache[text] = self.embed_texts([text])[0]
        return self._text_cache[text]

    @staticmethod
    def _box_iou(a: np.ndarray, b: np.ndarray) -> float:
        x0 = max(a[0], b[0]); y0 = max(a[1], b[1])
        x1 = min(a[2], b[2]); y1 = min(a[3], b[3])
        inter = max(0.0, x1 - x0) * max(0.0, y1 - y0)
        ar_a = (a[2] - a[0]) * (a[3] - a[1])
        ar_b = (b[2] - b[0]) * (b[3] - b[1])
        return inter / max(ar_a + ar_b - inter, 1e-6)

    def __call__(self, image: np.ndarray, text: str):
        self._prepare(image)
        if self._crop_embeds is None:
            return None
        if text in self._assigned:
            return self._assigned[text]
        sims = self._crop_embeds @ self._text_embed(text)
        order = np.argsort(-sims)
        taken = [self._proposals[i].box
                 for t, i in self._assigned_indices.items() if t != text]
        for i in order:
            if sims[i] < self.sim_thresh:
                break
            box = self._proposals[i].box
            if any(self._box_iou(box, tb) > self.overlap_thresh
                   for tb in taken):
                continue
            self._assigned[text] = box
            self._assigned_indices[text] = int(i)
            return box
        self._assigned[text] = None
        return None

    def assign_jointly(self, image: np.ndarray,
                       texts: Sequence[str]) -> None:
        """Assign all ``texts`` at once by the GLOBAL best similarity over
        (class, proposal) pairs, which removes the query-order dependence
        of repeated ``__call__`` (an early class with a weaker affinity
        taking a later class's best region). Classes already assigned on
        this image keep their boxes, which stay vetoed."""
        self._prepare(image)
        todo = [t for t in texts if t not in self._assigned]
        if self._crop_embeds is None or not todo:
            for t in texts:
                self._assigned.setdefault(t, None)
            return
        sims = np.stack([self._crop_embeds @ self._text_embed(t)
                         for t in todo])          # [T, P]
        taken = [self._proposals[i].box
                 for t, i in self._assigned_indices.items()]
        flat = np.argsort(-sims, axis=None)
        done = set()
        for k in flat:
            ti, pi = np.unravel_index(k, sims.shape)
            if sims[ti, pi] < self.sim_thresh:
                break                             # sorted: rest is lower
            t = todo[ti]
            if t in done:
                continue
            box = self._proposals[pi].box
            if any(self._box_iou(box, tb) > self.overlap_thresh
                   for tb in taken):
                continue
            self._assigned[t] = box
            self._assigned_indices[t] = int(pi)
            taken.append(box)
            done.add(t)
        for t in todo:
            self._assigned.setdefault(t, None)

    def masks_for(self, image: np.ndarray, texts: Sequence[str]) -> list:
        """Per-class proposal MASKS (no second SAM box->mask pass), the
        classes assigned jointly (see ``assign_jointly``)."""
        self.assign_jointly(image, texts)
        out = []
        for t in texts:
            box = self(image, t)
            if box is None:
                out.append(None)
                continue
            idx = self._assigned_indices.get(t)
            out.append(self._proposals[idx].mask.astype(np.float32)
                       if idx is not None else None)
        return out


def build_openvocab_detector(sam, *, clip_vision, clip_text, tokenizer,
                             grid: int = 8,
                             proposer_kwargs: Optional[dict] = None,
                             **det_kwargs) -> OpenVocabDetector:
    """The SAM-grid proposer and the CLIP embedders in a detector whose
    ``__call__`` drops into SamMaskProvider's box_provider slot."""
    from omg_tpu_torch.segment.sam_provider import SamPredictor
    proposer = SamGridProposer(SamPredictor(sam), grid=grid,
                               **(proposer_kwargs or {}))
    embed_image, embed_texts = clip_embedders(clip_vision, clip_text,
                                              tokenizer)
    return OpenVocabDetector(proposer, embed_image, embed_texts,
                             crop_size=clip_vision.cfg.image_size,
                             **det_kwargs)
