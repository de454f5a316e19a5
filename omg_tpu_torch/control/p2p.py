"""Prompt-to-prompt attention control (port of ``omg_tpu/control/p2p.py``).

The controller is host-side data plus a per-step view:
  * the word-replacement ``mapper`` and the per-step per-word
    ``cross_alpha`` blend schedule, built once per request in numpy;
  * ``P2PControl.at_step(i)`` -> ``P2PStepControl``, which the UNet's
    attention layers apply in the O(N²)-free lane form: substitute the
    source lane's q/k into the destination lane for self-attention inside
    the replace window, and rewrite the destination lane's cross-attention
    output as sdpa(q_A, k_A, M @ (α ⊙ V)) + sdpa(q_B, k_B, (1-α) ⊙ V).

The step index is a Python int here, so the window test is a host branch.

Lane-sharded batches (the multi-device stage 2): with a ``Split`` of the
lanes over a group, each rank holds a block of lanes and applies the
edits to the lanes it holds. Where the source and destination lanes sit on
different ranks, the source's owner broadcasts the rows the edit reads
(``self_lane_qk_sharded``, ``cross_lane_out_sharded``); no rows move when
both sit on one rank, nor outside the self-replace window.

The host-side token-alignment helpers (get_word_inds, time_words_alpha,
replacement_mapper) follow Google's Apache-2.0 prompt-to-prompt utilities
(github.com/google/prompt-to-prompt, ptp_utils.py / seq_aligner.py), as
the JAX package's do; the alignment walk is semantics-pinned.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from omg_tpu_torch.parallel import comm

MAX_WORDS = 77


def get_word_inds(text: str, word_place, tokenizer) -> np.ndarray:
    """Token indices (1-based, inside BOS..EOS) covering a given word."""
    split_text = text.split(" ")
    if isinstance(word_place, str):
        word_place = [i for i, w in enumerate(split_text) if w == word_place]
    elif isinstance(word_place, int):
        word_place = [word_place]
    out = []
    if len(word_place) > 0:
        words_encode = [tokenizer.decode([tok]).strip("#")
                        for tok in tokenizer.encode(text)][1:-1]
        cur_len, ptr = 0, 0
        for i, piece in enumerate(words_encode):
            cur_len += len(piece)
            if ptr in word_place:
                out.append(i + 1)
            if cur_len >= len(split_text[ptr]):
                ptr += 1
                cur_len = 0
    return np.array(out)


def time_words_alpha(prompts: Sequence[str], num_steps: int,
                     cross_replace_steps, tokenizer=None,
                     max_words: int = MAX_WORDS) -> np.ndarray:
    """Per-step, per-word cross-replace blend in [0,1] -> [S+1, P-1, W].

    ``cross_replace_steps`` is a float, (start, end) tuple, or a dict of
    word -> bounds with a "default_" key."""
    if not isinstance(cross_replace_steps, dict):
        cross_replace_steps = {"default_": cross_replace_steps}
    if "default_" not in cross_replace_steps:
        cross_replace_steps["default_"] = (0.0, 1.0)

    alpha = np.zeros((num_steps + 1, len(prompts) - 1, max_words), np.float32)

    def update(bounds, prompt_ind, word_inds=None):
        if isinstance(bounds, float) or isinstance(bounds, int):
            bounds = (0.0, float(bounds))
        start = int(bounds[0] * (num_steps + 1))
        end = int(bounds[1] * (num_steps + 1))
        if word_inds is None:
            word_inds = np.arange(max_words)
        alpha[:start, prompt_ind, word_inds] = 0
        alpha[start:end, prompt_ind, word_inds] = 1
        alpha[end:, prompt_ind, word_inds] = 0

    for i in range(len(prompts) - 1):
        update(cross_replace_steps["default_"], i)
    for key, bounds in cross_replace_steps.items():
        if key == "default_":
            continue
        for i in range(1, len(prompts)):
            inds = get_word_inds(prompts[i], key, tokenizer)
            if len(inds) > 0:
                update(bounds, i - 1, inds)
    return alpha


def replacement_mapper(prompts: Sequence[str], tokenizer=None,
                       max_words: int = MAX_WORDS) -> np.ndarray:
    """Word-level token mapper between prompt 0 and prompt 1 -> [W, W];
    identity when the prompts are equal (the only case OMG exercises)."""
    x, y = prompts[0], prompts[1]
    if x == y or tokenizer is None:
        return np.eye(max_words, dtype=np.float32)

    words_x, words_y = x.split(" "), y.split(" ")
    if len(words_x) != len(words_y):
        raise ValueError(
            "attention replacement edit needs prompts with the same word "
            f"count, got {len(words_x)} vs {len(words_y)}")
    inds_replace = [i for i in range(len(words_y)) if words_y[i] != words_x[i]]
    inds_source = [get_word_inds(x, i, tokenizer) for i in inds_replace]
    inds_target = [get_word_inds(y, i, tokenizer) for i in inds_replace]
    mapper = np.zeros((max_words, max_words), dtype=np.float32)
    i = j = 0
    cur_inds = 0
    while i < max_words and j < max_words:
        if cur_inds < len(inds_source) and inds_source[cur_inds][0] == i:
            inds_s, inds_t = inds_source[cur_inds], inds_target[cur_inds]
            if len(inds_s) == len(inds_t):
                mapper[inds_s, inds_t] = 1
            else:
                ratio = 1 / len(inds_t)
                for t in inds_t:
                    mapper[inds_s, t] = ratio
            i += len(inds_s)
            j += len(inds_t)
            cur_inds += 1
        else:
            mapper[i, j] = 1
            i += 1
            j += 1
    return mapper


@dataclasses.dataclass(frozen=True)
class P2PControl:
    """Immutable P2P schedule. ``at_step(i)`` yields the per-step control."""

    mapper: torch.Tensor        # [W, W] fp32
    cross_alpha: torch.Tensor   # [S+1, W] fp32 (single edit: P-1 == 1)
    self_start: int             # step bounds for self-attn replace
    self_end: int
    self_seq_limit: int         # replace self-attn only if Nq <= limit

    @classmethod
    def build(cls, prompts: Sequence[str], num_steps: int, *,
              cross_replace_steps=1.0, self_replace_steps=0.4,
              width: int = 32, height: int = 32, tokenizer=None,
              device=None) -> "P2PControl":
        """AttentionReplace defaults: cross_replace_steps 1.0,
        self_replace_steps 0.4, width = height = 1024 // 32."""
        alpha = time_words_alpha(prompts, num_steps, cross_replace_steps,
                                 tokenizer)
        mapper = replacement_mapper(prompts, tokenizer)
        if isinstance(self_replace_steps, (int, float)):
            self_replace_steps = (0.0, float(self_replace_steps))
        return cls(
            mapper=torch.as_tensor(mapper, device=device),
            cross_alpha=torch.as_tensor(alpha[:, 0], device=device),
            self_start=int(num_steps * self_replace_steps[0]),
            self_end=int(num_steps * self_replace_steps[1]),
            self_seq_limit=width * height)

    def at_step(self, step: int, *, src_lane: int = 2, dst_lane: int = 3,
                lanes=None) -> "P2PStepControl":
        """``src_lane``/``dst_lane``: the batch rows of cond-A (edit
        source) and cond-B (edit target); the 3-row stage-2 layout uses
        0/2. ``lanes``: a ``parallel.mesh.Split`` when the batch's lanes
        are split over ranks (lane numbers stay global)."""
        return P2PStepControl(self, step, src_lane=src_lane,
                              dst_lane=dst_lane, lanes=lanes)


def _substitute(t: torch.Tensor, row: int, new: torch.Tensor) -> torch.Tensor:
    """``t`` with batch row ``row`` replaced by ``new`` [1, ...]."""
    return torch.cat([t[:row], new, t[row + 1:]])


class P2PStepControl:
    """The attention-control protocol bound to one step."""

    def __init__(self, ctl: P2PControl, step: int, *, src_lane: int = 2,
                 dst_lane: int = 3, lanes=None):
        self.ctl = ctl
        self.step = int(step)
        self.src_lane = src_lane
        self.dst_lane = dst_lane
        self.lanes = lanes

    def wants(self, *, is_cross: bool, num_queries: int) -> bool:
        """Cross-attn is always edited (alpha may be 0 at some steps);
        self-attn only on layers with Nq <= width*height and only if the
        schedule has a non-empty replace window."""
        if is_cross:
            return True
        return num_queries <= self.ctl.self_seq_limit and self.ctl.self_end > 0

    def _in_window(self) -> bool:
        return self.ctl.self_start <= self.step < self.ctl.self_end

    def self_lane_qk(self, q: torch.Tensor, k: torch.Tensor) -> tuple:
        """Self-attn replace: dst lane takes the src lane's q and k inside
        the window. q, k: [B, H, N, D]."""
        if self.lanes is not None:
            return self.self_lane_qk_sharded(q, k)
        if not self._in_window():
            return q, k
        rows = list(range(q.shape[0]))
        rows[self.dst_lane] = self.src_lane
        idx = torch.as_tensor(rows, device=q.device)
        return q.index_select(0, idx), k.index_select(0, idx)

    def _cross_edit(self, q_s, k_s, q_d, k_d, v_d, sdpa_fn) -> torch.Tensor:
        """The dst lane's rewritten cross-attn output [1, H, Nq, D] from the
        src lane's q/k and the dst lane's q/k/v (each [1, H, N, D])."""
        ctl = self.ctl
        nk = k_d.shape[2]
        alpha = ctl.cross_alpha[self.step, :nk].to(device=v_d.device,
                                                   dtype=v_d.dtype)
        alpha = alpha[None, :, None]                          # [1, Nk, 1]
        mapper = ctl.mapper[:nk, :nk].to(device=v_d.device, dtype=v_d.dtype)
        va = torch.einsum("wn,hnd->hwd", mapper, v_d[0] * alpha)
        vb = v_d[0] * (1.0 - alpha)
        return sdpa_fn(q_s, k_s, va[None]) + sdpa_fn(q_d, k_d, vb[None])

    def cross_lane_out(self, out: torch.Tensor, q: torch.Tensor,
                       k: torch.Tensor, v: torch.Tensor,
                       sdpa_fn) -> torch.Tensor:
        """Rewrite the dst lane of a cross-attn output without probs.
        out/q/k/v: [B, H, N(q/k), D]; sdpa_fn(q, k, v) -> attention out."""
        if self.lanes is not None:
            return self.cross_lane_out_sharded(out, q, k, v, sdpa_fn)
        s, d = self.src_lane, self.dst_lane
        new = self._cross_edit(q[s:s + 1], k[s:s + 1], q[d:d + 1],
                               k[d:d + 1], v[d:d + 1], sdpa_fn)
        return _substitute(out, d, new)

    # -- lane-sharded forms (multi-device stage 2) -------------------------

    def _owners(self) -> tuple:
        """(src owner, dst owner, this rank's index, first local lane)."""
        sp = self.lanes
        return (sp.owner(self.src_lane), sp.owner(self.dst_lane),
                sp.group.index, sp.lo)

    def self_lane_qk_sharded(self, q: torch.Tensor, k: torch.Tensor) -> tuple:
        """``self_lane_qk`` on this rank's lanes q, k [hi-lo, H, N, D]. The
        window test is a host decision: outside it nothing moves."""
        if not self._in_window():
            return q, k
        so, do, me, lo = self._owners()
        s, d = self.src_lane - lo, self.dst_lane - lo
        if so == do:
            if me != do:
                return q, k
            return (_substitute(q, d, q[s:s + 1]),
                    _substitute(k, d, k[s:s + 1]))
        rows = (torch.cat([q[s:s + 1], k[s:s + 1]]) if me == so
                else q.new_empty((2,) + tuple(q.shape[1:])))
        rows = comm.broadcast_rows(rows, so, self.lanes.group)
        if me != do:
            return q, k
        return _substitute(q, d, rows[:1]), _substitute(k, d, rows[1:])

    def cross_lane_out_sharded(self, out: torch.Tensor, q: torch.Tensor,
                               k: torch.Tensor, v: torch.Tensor,
                               sdpa_fn) -> torch.Tensor:
        """``cross_lane_out`` on this rank's lanes: the src lane's q/k come
        from its owner when the dst lane is held elsewhere; only the dst
        lane's owner computes the edit."""
        so, do, me, lo = self._owners()
        s, d = self.src_lane - lo, self.dst_lane - lo
        if so == do:
            if me != do:
                return out
            q_s, k_s = q[s:s + 1], k[s:s + 1]
        else:
            q_s, k_s = ((q[s:s + 1], k[s:s + 1]) if me == so else
                        (q.new_empty((1,) + tuple(q.shape[1:])),
                         k.new_empty((1,) + tuple(k.shape[1:]))))
            q_s = comm.broadcast_rows(q_s, so, self.lanes.group)
            k_s = comm.broadcast_rows(k_s, so, self.lanes.group)
        if me != do:
            return out
        new = self._cross_edit(q_s, k_s, q[d:d + 1], k[d:d + 1],
                               v[d:d + 1], sdpa_fn)
        return _substitute(out, d, new)
