"""Multi-head attention with OMG's control semantics as explicit inputs
(port of ``omg_tpu/nn/attention.py``).

``Attention`` takes optional LoRA deltas (the model's flat adapter dict),
an optional P2P step control in the O(N²)-free lane form
(``control/p2p.py``): q/k lane substitution before self-attention, the
cross-attention output rewrite after it; and, on a cross-attention, the
IP-Adapter's decoupled branch (``IPKV``): a second attention of the same
queries over the image-prompt tokens, added with ``ip_scale`` after the
P2P rewrite.

Under tensor parallelism (``parallel/sharding.py``: ``to_q``/``to_k``/
``to_v`` and the IP projections split by output columns, ``to_out`` by
input rows over the model group) each rank runs its own heads, K1 on
[B, H/m, N, D], the P2P edits per head as unsharded, and its partial
``to_out``, summed over the group with the bias after the sum. Where the
model size m does not divide the heads, a rank's columns are not whole
heads: it gathers the q/k/v columns of every rank, runs all heads, and
keeps its own columns of the output for the row-split ``to_out`` (GSPMD
reshards there in JAX).

Under a ``seq_group`` (the spatially split stage 1 and VAE decode) each
rank holds one block of the token sequence. Self-attention then
all-gathers K/V over the group and runs its local query rows against
them: K1b on a CUDA device where the sequence-local gate admits the
shape, the plain version otherwise. Cross-attention reads the whole
(replicated) context and stays local.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from omg_tpu_torch.nn import layers
from omg_tpu_torch.ops import flash_attention as fa
from omg_tpu_torch.ops import quant
from omg_tpu_torch.parallel import comm
from omg_tpu_torch.utils import profiling

# Sequence-sharded self-attentions that ran the plain version (CPU
# tensors, or shapes the sequence-local gate refuses); K1b launches are
# counted in ops.flash_attention.SEQ_LAUNCHES.
SEQ_PLAIN_CALLS = 0


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


def seq_sharded_sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     group: comm.Group) -> torch.Tensor:
    """Self-attention over a sequence split into equal blocks over
    ``group``; q/k/v: this rank's block [B, H, N/S, D]. The gate reads the
    global length (local x shards), as the JAX ``sdpa`` under
    ``seq_sharded`` does."""
    global SEQ_PLAIN_CALLS
    n_global = k.shape[2] * group.size
    if (q.shape[2] * group.size == n_global
            and fa.use_flash(q.shape[2], n_global, q.shape[3], q.device,
                             seq_local=True)):
        return fa.flash_attention_seq_sharded(q, k, v, group=group)
    SEQ_PLAIN_CALLS += 1
    return sdpa(q, comm.all_gather(k, 2, group), comm.all_gather(v, 2, group))


def _plus_lora(y: torch.Tensor, lin: layers.Linear, inp: torch.Tensor,
               lora: Optional[dict]) -> torch.Tensor:
    leaf = lin.lora_leaf(lora)
    return y if leaf is None else y + lin.counted_delta(leaf, inp, lora)


def _fused(inp: torch.Tensor, members: tuple,
           lora: Optional[dict]) -> tuple:
    """One product over the concatenated projections ``members`` (one
    layout: float, or int8 whose per-output-channel scales concatenate
    exactly), their LoRA deltas in it -> each member's output. A float
    product takes the members' deltas through one down GEMM and one
    up GEMM accumulated into it (``layers.lora_group``); an int8 one
    adds each member's delta to its chunk."""
    if members[0].quantized:
        y = quant.int8_matmul(inp, torch.cat([m.weight_q for m in members]),
                              torch.cat([m.w_scale for m in members]))
        return tuple(_plus_lora(c, m, inp, lora) for c, m in
                     zip(y.chunk(len(members), dim=-1), members))
    y = F.linear(inp, torch.cat([m.weight for m in members]))
    group = layers.lora_group(members, lora, inp)
    if group is not None:
        layers.add_lora_(y, inp, *group)
    return y.chunk(len(members), dim=-1)


class IPKV(nn.Module):
    """One attn2's IP-Adapter projections over the image-prompt tokens
    (no bias: a lane with zero tokens gets a zero branch)."""

    def __init__(self, context_dim: int, inner_dim: int, *,
                 dtype=torch.float32, device=None):
        super().__init__()
        kw = dict(bias=False, dtype=dtype, device=device)
        self.to_k_ip = layers.Linear(context_dim, inner_dim, **kw)
        self.to_v_ip = layers.Linear(context_dim, inner_dim, **kw)


class Attention(nn.Module):
    """diffusers Attention: to_q/to_k/to_v/to_out.0 over [B, N, C]."""

    def __init__(self, query_dim: int, *, context_dim: Optional[int] = None,
                 num_heads: int, head_dim: int, out_bias: bool = True,
                 qkv_bias: bool = False, dtype=torch.float32, device=None):
        super().__init__()
        inner = num_heads * head_dim
        ctx = context_dim if context_dim is not None else query_dim
        kw = dict(dtype=dtype, device=device)
        self.num_heads, self.head_dim = num_heads, head_dim
        self.to_q = layers.Linear(query_dim, inner, bias=qkv_bias, **kw)
        self.to_k = layers.Linear(ctx, inner, bias=qkv_bias, **kw)
        self.to_v = layers.Linear(ctx, inner, bias=qkv_bias, **kw)
        self.to_out = nn.ModuleList(
            [layers.Linear(inner, query_dim, bias=out_bias, **kw)])

    def _split_heads(self, t: torch.Tensor) -> torch.Tensor:
        """[B, N, H'*D] -> [B, H', N, D] as a strided view (no copy). Under
        tensor parallelism: the heads this rank runs, from its columns (or
        from all columns, where a projection was left whole)."""
        tp = self.to_q.tp
        if tp is not None:
            whole = self.num_heads * self.head_dim
            if self.num_heads % tp.split.group.size == 0:
                if t.shape[-1] == whole:
                    t = t[..., tp.split.lo:tp.split.hi]
            elif t.shape[-1] != whole:
                t = comm.all_gather(t, -1, tp.split.group,
                                    sizes=tp.split.sizes)
        return t.unflatten(-1, (-1, self.head_dim)).transpose(1, 2)

    def forward(self, x: torch.Tensor, context: Optional[torch.Tensor] = None,
                *, lora: Optional[dict] = None, p2p=None,
                seq_group: Optional[comm.Group] = None,
                ip: Optional[IPKV] = None,
                ip_context: Optional[torch.Tensor] = None,
                ip_scale: float = 1.0) -> torch.Tensor:
        """``seq_group``: x holds this rank's block of the token sequence
        (self-attention gathers K/V over the group). ``ip``/``ip_context``
        ([B, T, C_ctx] image-prompt tokens): the decoupled IP branch."""
        is_cross = context is not None
        ctx = context if is_cross else x
        fusable = (self.to_q.bias is None and self.to_k.bias is None
                   and self.to_v.bias is None)
        # a fused product needs one layout over its members: the int8
        # mode's min_dim gate may leave a small projection in float beside
        # quantized ones, and such a group takes the per-projection path
        same_qkv = len({m.quantized for m in (self.to_q, self.to_k,
                                              self.to_v)}) == 1
        if fusable and not is_cross and same_qkv:
            # one [C, 3*inner] product for q, k and v (same input)
            q, k, v = _fused(x, (self.to_q, self.to_k, self.to_v), lora)
        elif fusable and is_cross and \
                self.to_k.quantized == self.to_v.quantized:
            # one [C_ctx, 2*inner] product for k and v over the context
            q = self.to_q(x, lora)
            k, v = _fused(ctx, (self.to_k, self.to_v), lora)
        else:
            q = self.to_q(x, lora)
            k = self.to_k(ctx, lora)
            v = self.to_v(ctx, lora)

        qh, kh, vh = self._split_heads(q), self._split_heads(k), \
            self._split_heads(v)
        p2p_active = p2p is not None and p2p.wants(is_cross=is_cross,
                                                  num_queries=x.shape[1])
        if p2p_active and seq_group is not None:
            raise ValueError("P2P control runs on whole lanes; the sequence-"
                             "split layout (stage 1) has none")
        if p2p_active and not is_cross:
            qh, kh = p2p.self_lane_qk(qh, kh)
        if seq_group is not None and seq_group.size > 1 and not is_cross:
            out = seq_sharded_sdpa(qh, kh, vh, seq_group)
        else:
            out = sdpa(qh, kh, vh)
        if p2p_active and is_cross:
            out = p2p.cross_lane_out(out, qh, kh, vh, sdpa)
        if ip is not None and ip_context is not None:
            profiling.count("ip.kv_projections", 2)     # to_k_ip, to_v_ip
            ip_out = sdpa(qh, self._split_heads(ip.to_k_ip(ip_context)),
                          self._split_heads(ip.to_v_ip(ip_context)))
            out = out + torch.full((), float(ip_scale), dtype=out.dtype,
                                   device=out.device) * ip_out

        b, h, n, d = out.shape
        out = out.transpose(1, 2).reshape(b, n, h * d)
        tp = self.to_out[0].tp
        if tp is not None and h == self.num_heads:
            # all heads ran (m does not divide them): this rank's rows
            out = out[..., tp.split.lo:tp.split.hi]
        return self.to_out[0](out, lora)
