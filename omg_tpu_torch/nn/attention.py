"""Multi-head attention with OMG's control semantics as explicit inputs
(port of ``omg_tpu/nn/attention.py``).

``Attention`` takes optional LoRA deltas (the model's flat adapter dict)
and an optional P2P step control in the O(N²)-free lane form
(``control/p2p.py``): q/k lane substitution before self-attention, the
cross-attention output rewrite after it. The IP-Adapter branch comes with
the InstantID slice.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from omg_tpu_torch.nn import layers
from omg_tpu_torch.ops import flash_attention as fa


def sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
         mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Scaled dot-product attention on [B, H, N, D].

    Large dense self-attention on a CUDA device goes to the flash kernel
    (``ops/flash_attention.py``); everything else runs the plain form: fp32
    scores and softmax, probabilities cast to ``v.dtype`` before P.V."""
    if mask is None and fa.use_flash(q.shape[2], k.shape[2], q.shape[3],
                                     q.device):
        return fa.flash_attention(q, k, v)
    scale = q.shape[-1] ** -0.5
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if mask is not None:
        scores = scores + mask
    probs = torch.softmax(scores, dim=-1)
    return torch.matmul(probs.to(v.dtype), v)


def _plus_lora(y: torch.Tensor, lin: layers.Linear, inp: torch.Tensor,
               lora: Optional[dict]) -> torch.Tensor:
    leaf = lin.lora_leaf(lora)
    return y if leaf is None else y + layers.lora_delta(leaf, inp)


class Attention(nn.Module):
    """diffusers Attention: to_q/to_k/to_v/to_out.0 over [B, N, C]."""

    def __init__(self, query_dim: int, *, context_dim: Optional[int] = None,
                 num_heads: int, head_dim: int, out_bias: bool = True,
                 qkv_bias: bool = False, dtype=torch.float32, device=None):
        super().__init__()
        inner = num_heads * head_dim
        ctx = context_dim if context_dim is not None else query_dim
        kw = dict(dtype=dtype, device=device)
        self.num_heads = num_heads
        self.to_q = layers.Linear(query_dim, inner, bias=qkv_bias, **kw)
        self.to_k = layers.Linear(ctx, inner, bias=qkv_bias, **kw)
        self.to_v = layers.Linear(ctx, inner, bias=qkv_bias, **kw)
        self.to_out = nn.ModuleList(
            [layers.Linear(inner, query_dim, bias=out_bias, **kw)])

    def _split_heads(self, t: torch.Tensor) -> torch.Tensor:
        # [B, N, H*D] -> [B, H, N, D] as a strided view (no copy)
        return t.unflatten(-1, (self.num_heads, -1)).transpose(1, 2)

    def forward(self, x: torch.Tensor, context: Optional[torch.Tensor] = None,
                *, lora: Optional[dict] = None, p2p=None) -> torch.Tensor:
        is_cross = context is not None
        ctx = context if is_cross else x
        fusable = (self.to_q.bias is None and self.to_k.bias is None
                   and self.to_v.bias is None)
        if fusable and not is_cross:
            # one [C, 3*inner] product for q, k and v (same input)
            w = torch.cat([self.to_q.weight, self.to_k.weight,
                           self.to_v.weight])
            q, k, v = F.linear(x, w).chunk(3, dim=-1)
            q = _plus_lora(q, self.to_q, x, lora)
            k = _plus_lora(k, self.to_k, x, lora)
            v = _plus_lora(v, self.to_v, x, lora)
        elif fusable:
            # one [C_ctx, 2*inner] product for k and v over the context
            q = self.to_q(x, lora)
            w = torch.cat([self.to_k.weight, self.to_v.weight])
            k, v = F.linear(ctx, w).chunk(2, dim=-1)
            k = _plus_lora(k, self.to_k, ctx, lora)
            v = _plus_lora(v, self.to_v, ctx, lora)
        else:
            q = self.to_q(x, lora)
            k = self.to_k(ctx, lora)
            v = self.to_v(ctx, lora)

        qh, kh, vh = self._split_heads(q), self._split_heads(k), \
            self._split_heads(v)
        p2p_active = p2p is not None and p2p.wants(is_cross=is_cross,
                                                  num_queries=x.shape[1])
        if p2p_active and not is_cross:
            qh, kh = p2p.self_lane_qk(qh, kh)
        out = sdpa(qh, kh, vh)
        if p2p_active and is_cross:
            out = p2p.cross_lane_out(out, qh, kh, vh, sdpa)

        b, h, n, d = out.shape
        out = out.transpose(1, 2).reshape(b, n, h * d)
        return self.to_out[0](out, lora)
