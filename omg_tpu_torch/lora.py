"""LoRA adapters: files and algebra (port of ``omg_tpu/lora.py``).

An adapter is data, not a weight edit: a flat dict
``{module_path: {"down": [in, r], "up": [r, out], "scale": ()}}`` keyed by
the diffusers path of the ``Linear`` it applies to (see ``nn/layers.py``).
A concept may also be ``{"unet": ..., "text_encoder": ...,
"text_encoder_2": ...}`` with one such dict per model; ``load_lora``
returns that form.

LoRA files come in three layouts, all read here:
  * kohya-ss: ``lora_unet_<path>.lora_down.weight`` / ``lora_up.weight``
    and ``.alpha``, the module path flattened with "_" (``lora_te1_`` /
    ``lora_te2_`` for the text encoders);
  * diffusers/PEFT: ``unet.<path>.lora_A.weight`` / ``lora_B.weight``;
  * the old unprefixed attn-procs export: ``<block path>.processor.
    to_q_lora.down.weight``.
The scale is ``weight * alpha / rank`` (alpha = rank when the file has
none). 1x1 conv LoRAs are squeezed to linear ones; k x k conv LoRAs are
skipped, as the JAX package skips them (a corner tap would corrupt the
adapter). A key that names no ``Linear`` of the model does nothing at
run time, so the tests hold every loaded key to a LoRA-bearing linear.
"""

from __future__ import annotations

import re
from typing import Mapping, Optional, Sequence

import torch

from omg_tpu_torch import convert
from omg_tpu_torch.nn import layers

MODELS = ("unet", "text_encoder", "text_encoder_2")

_KOHYA_RE = re.compile(r"^lora_(unet|te1|te2|te)_(.+)$")
_KOHYA_MODEL = {"unet": "unet", "te": "text_encoder", "te1": "text_encoder",
                "te2": "text_encoder_2"}
# kohya flattens module paths with "_": these multi-word module names are
# re-joined before the split (the JAX package's list, and the names of the
# embeddings and of conv_in/conv_out, which it splits apart).
_MULTIWORD = sorted([
    "down_blocks", "up_blocks", "mid_block", "transformer_blocks",
    "attentions", "resnets", "to_q", "to_k", "to_v", "to_out",
    "proj_in", "proj_out", "ff_net", "time_emb_proj", "conv_shortcut",
    "text_model", "self_attn", "q_proj", "k_proj", "v_proj", "out_proj",
    "time_embedding", "add_embedding", "linear_1", "linear_2", "conv_in",
    "conv_out", "text_projection"], key=len, reverse=True)


load_safetensors = convert.load_safetensors


def _kohya_tokens(flat: str) -> list:
    """'down_blocks_1_attentions_0_...' -> ['down_blocks', '1', ...]."""
    s = flat
    for tok in _MULTIWORD:
        s = s.replace(tok, tok.replace("_", "\x00"))
    return [p.replace("\x00", "_") for p in s.split("_") if p]


def _module_path(tokens: list) -> str:
    """Tokens -> the port's dotted module path: kohya's ``ff_net`` is
    ``ff.net``, and ``to_out`` without its index is ``to_out.0``."""
    out = []
    for i, t in enumerate(tokens):
        if t == "ff_net":
            out += ["ff", "net"]
        elif t == "to_out" and tokens[i + 1:i + 2] != ["0"]:
            out += ["to_out", "0"]
        else:
            out.append(t)
    return ".".join(out)


def _parse_key(key: str):
    """A LoRA file key -> (model, module tokens, role) or None, role being
    "down", "up" or "alpha"."""
    m = _KOHYA_RE.match(key)
    if m:
        prefix, rest = m.groups()
        flat, _, tail = rest.partition(".")
        role = ("down" if "lora_down" in tail else
                "up" if "lora_up" in tail else
                "alpha" if tail == "alpha" else None)
        return _KOHYA_MODEL[prefix], _kohya_tokens(flat), role
    parts = key.split(".")
    if parts[0] in MODELS:
        model = parts[0]
    elif parts[0] in ("down_blocks", "up_blocks", "mid_block") and \
            "lora" in key:
        model, parts = "unet", ["unet"] + parts      # attn-procs export
    else:
        return None
    if "lora_A" in parts:
        return model, parts[1:parts.index("lora_A")], "down"
    if "lora_B" in parts:
        return model, parts[1:parts.index("lora_B")], "up"
    if parts[-1] == "alpha":
        return model, parts[1:-1], "alpha"
    if "lora" in key and ("down" in parts or "up" in parts):
        # ...processor.to_q_lora.down.weight: drop the processor wrapper
        # and the _lora suffix
        role = "down" if "down" in parts else "up"
        idx = parts.index(role)
        return model, [t[:-5] if t.endswith("_lora") else t
                       for t in parts[1:idx] if t != "processor"], role
    return None


def lora_from_state_dict(sd: Mapping, *, weight: float = 1.0,
                         device="cuda") -> dict:
    """A LoRA state dict -> {"unet", "text_encoder", "text_encoder_2"}
    flat adapter dicts of fp32 leaves on ``device``, keyed by the port's
    module paths. Files store down [r, in] and up [out, r]; the leaves are
    down [in, r] and up [r, out]."""
    device = layers.target_device(device, "lora_from_state_dict")
    groups: dict = {}
    for key, val in sd.items():
        parsed = _parse_key(key)
        if parsed is None or parsed[2] is None:
            continue
        model, tokens, role = parsed
        groups.setdefault((model, _module_path(tokens)), {})[role] = \
            torch.as_tensor(val)
    out: dict = {m: {} for m in MODELS}
    for (model, path), roles in groups.items():
        if "down" not in roles or "up" not in roles:
            continue
        down, up = roles["down"], roles["up"]
        rank = down.shape[0]
        alpha = float(roles["alpha"]) if "alpha" in roles else float(rank)
        if down.dim() == 4:
            if down.shape[2:] != (1, 1) or up.shape[2:] != (1, 1):
                continue                    # k x k conv LoRA: skipped
            down, up = down[:, :, 0, 0], up[:, :, 0, 0]
        out[model][path] = {
            "down": down.float().T.contiguous().to(device),
            "up": up.float().T.contiguous().to(device),
            "scale": torch.tensor(weight * alpha / rank,
                                  dtype=torch.float32, device=device)}
    return out


def load_lora(path: str, *, weight: float = 1.0, device="cuda") -> dict:
    """A LoRA file (safetensors, or a torch pickle) -> the concept form
    ``{"unet", "text_encoder", "text_encoder_2"}`` on ``device``."""
    return lora_from_state_dict(convert.load_state_dict(path),
                                weight=weight, device=device)


def scale_lora(tree: Optional[dict], s: float) -> Optional[dict]:
    """Multiply every delta's scale (the reference's
    ``cross_attention_kwargs={'scale': 0.8}`` on concept UNet calls)."""
    if tree is None:
        return None
    return {k: {**leaf, "scale": leaf["scale"] * s} for k, leaf in tree.items()}


class LaneStack(dict):
    """``stack_loras``'s result: the stacked leaves by module path, and
    ``live``, per path whether each lane holds an adapter's delta rather
    than the zero pad (known on the host; ``layers.Linear`` counts it)."""

    def __init__(self, leaves: dict, live: list):
        super().__init__(leaves)
        self.live = live


def prepare(tree: Optional[dict], dtype) -> Optional[layers.LoraFactors]:
    """A shared adapter (one flat dict for every lane) as the forward
    reads it: each leaf's factors in the compute dtype ``dtype``, its scale
    folded into ``up`` (``layers.lora_factors``). A request makes this once
    at its entry and drops it when it returns."""
    if tree is None:
        return None
    return layers.LoraFactors({k: layers.lora_factors(leaf, dtype)
                               for k, leaf in tree.items()})


def stack_loras(trees: Sequence[Optional[dict]], *, repeat: int = 1,
                dtype=None):
    """Stack adapters into per-lane deltas for one batched forward.

    Leaves become ``{"down": [L*repeat, in, r], "up": [L*repeat, r, out],
    "scale": [L*repeat]}`` with L = len(trees); lane ``i*repeat + j`` runs
    tree i. Ranks are zero-padded to the largest, and paths missing from a
    tree (or a None tree) contribute zero deltas, which ``live`` leaves
    out. With ``dtype`` the lanes are the forward's factors in that dtype
    (a ``layers.LoraFactors``, each adapter's leaf cast once and its scale
    folded into ``up``; a zero-pad lane's factors are zero), and no fp32
    stack is made."""
    if all(t is None for t in trees):
        return None
    keys = sorted({k for t in trees if t is not None for k in t})
    out, lane_live = {}, {}
    for key in keys:
        leaves = [None if t is None else t.get(key) for t in trees]
        lane_live[key] = tuple(n is not None for n in leaves
                               for _ in range(repeat))
        made: dict = {}
        for n in leaves:
            if n is not None and id(n) not in made:
                made[id(n)] = (n if dtype is None
                               else layers.lora_factors(n, dtype))
        live = list(made.values())
        d0, u0 = live[0]["down"], live[0]["up"]
        rmax = max(n["down"].shape[-1] for n in live)
        zero = {"down": d0.new_zeros(d0.shape[:-1] + (rmax,)),
                "up": u0.new_zeros(u0.shape[:-2] + (rmax,) + u0.shape[-1:])}
        if dtype is None:
            zero["scale"] = torch.zeros((), dtype=torch.float32,
                                        device=d0.device)
        padded = {}
        for i, n in made.items():
            r = n["down"].shape[-1]
            padded[i] = {
                "down": torch.nn.functional.pad(n["down"], (0, rmax - r)),
                "up": torch.nn.functional.pad(n["up"], (0, 0, 0, rmax - r))}
            if dtype is None:
                padded[i]["scale"] = torch.as_tensor(
                    n["scale"], dtype=torch.float32, device=d0.device)
        lanes = [zero if n is None else padded[id(n)] for n in leaves
                 for _ in range(repeat)]
        out[key] = {role: torch.stack([lane[role] for lane in lanes])
                    for role in zero}
    if dtype is None:
        return LaneStack(out, lane_live)
    return layers.LoraFactors(out, lane_live)


def align_loras(trees: Sequence[Optional[dict]]) -> list:
    """Make adapters structurally identical: the union of their paths,
    zero-filled gaps and ranks zero-padded to the largest, as
    ``stack_loras`` stacks them (stacked, then unstacked, so the padding
    rules live in one place). The reference's ``generate_batch`` needs this
    to map one program over requests; the port folds requests into the
    lane axis, where ``stack_loras`` pads directly, so its batch path does
    not call it."""
    stacked = stack_loras(trees)
    if stacked is None:
        return [None] * len(trees)
    return [{k: {role: leaf[i] for role, leaf in lf.items()}
             for k, lf in stacked.items()} for i in range(len(trees))]


def lane_slice(stacked, lo: int, hi: int):
    """Lanes [lo, hi) of a ``stack_loras`` result, of the same kind: the
    rows one rank keeps when a batch's lanes split over ranks."""
    if stacked is None:
        return None
    return type(stacked)({k: {role: leaf[lo:hi] for role, leaf in lf.items()}
                          for k, lf in stacked.items()},
                         {k: v[lo:hi] for k, v in stacked.live.items()})


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
