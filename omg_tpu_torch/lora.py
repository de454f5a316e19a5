"""LoRA adapter algebra (port of ``omg_tpu/lora.py``).

An adapter is data, not a weight edit: a flat dict
``{module_path: {"down": [in, r], "up": [r, out], "scale": ()}}`` keyed by
the diffusers path of the ``Linear`` it applies to (see ``nn/layers.py``).
A concept may also be ``{"unet": ..., "text_encoder": ...,
"text_encoder_2": ...}`` with one such dict per model.

Loading LoRA files (kohya and diffusers layouts) comes with weight
loading (ROADMAP.md).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch


def scale_lora(tree: Optional[dict], s: float) -> Optional[dict]:
    """Multiply every delta's scale (the reference's
    ``cross_attention_kwargs={'scale': 0.8}`` on concept UNet calls)."""
    if tree is None:
        return None
    return {k: {**leaf, "scale": leaf["scale"] * s} for k, leaf in tree.items()}


def stack_loras(trees: Sequence[Optional[dict]], *,
                repeat: int = 1) -> Optional[dict]:
    """Stack adapters into per-lane deltas for one batched forward.

    Leaves become ``{"down": [L*repeat, in, r], "up": [L*repeat, r, out],
    "scale": [L*repeat]}`` with L = len(trees); lane ``i*repeat + j`` runs
    tree i. Ranks are zero-padded to the largest, and paths missing from a
    tree (or a None tree) contribute zero deltas."""
    if all(t is None for t in trees):
        return None
    keys = sorted({k for t in trees if t is not None for k in t})
    out = {}
    for key in keys:
        leaves = [None if t is None else t.get(key) for t in trees]
        live = [n for n in leaves if n is not None]
        d0, u0 = live[0]["down"], live[0]["up"]
        rmax = max(n["down"].shape[-1] for n in live)
        downs, ups, scales = [], [], []
        for n in leaves:
            if n is None:
                d = d0.new_zeros(d0.shape[:-1] + (rmax,))
                u = u0.new_zeros(u0.shape[:-2] + (rmax,) + u0.shape[-1:])
                s = torch.zeros((), dtype=torch.float32, device=d0.device)
            else:
                r = n["down"].shape[-1]
                d = torch.nn.functional.pad(n["down"], (0, rmax - r))
                u = torch.nn.functional.pad(n["up"], (0, 0, 0, rmax - r))
                s = torch.as_tensor(n["scale"], dtype=torch.float32,
                                    device=d0.device)
            downs += [d] * repeat
            ups += [u] * repeat
            scales += [s] * repeat
        out[key] = {"down": torch.stack(downs), "up": torch.stack(ups),
                    "scale": torch.stack(scales)}
    return out


def lane_slice(stacked: Optional[dict], lo: int, hi: int) -> Optional[dict]:
    """Lanes [lo, hi) of a ``stack_loras`` result: the rows one rank keeps
    when a batch's lanes split over ranks."""
    if stacked is None:
        return None
    return {k: {role: leaf[lo:hi] for role, leaf in lf.items()}
            for k, lf in stacked.items()}


def merge_loras(trees: Sequence[Optional[dict]],
                weights: Sequence[float]) -> Optional[dict]:
    """Combine adapters by rank concatenation, weights folded into up:
    sum_i w_i s_i x d_i u_i == x [d_1|..|d_n] [w_1 s_1 u_1; ...]
    (the reference's ``set_adapters([char, style], [0.7, 0.5])``)."""
    live = [(t, w) for t, w in zip(trees, weights) if t is not None]
    if not live:
        return None
    out = {}
    for key in sorted({k for t, _ in live for k in t}):
        leaves = [(t[key], w) for t, w in live if key in t]
        out[key] = {
            "down": torch.cat([n["down"] for n, _ in leaves], dim=1),
            "up": torch.cat([n["up"] * (torch.as_tensor(n["scale"]).to(
                n["up"]) * w) for n, w in leaves], dim=0),
            "scale": torch.ones((), dtype=torch.float32,
                                device=leaves[0][0]["down"].device)}
    return out
