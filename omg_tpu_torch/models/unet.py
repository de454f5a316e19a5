"""SDXL UNet2DConditionModel (port of ``omg_tpu/models/unet.py``).

Submodule names follow the diffusers state_dict, which the JAX parameter
tree mirrors (``ff.net.0.proj``/``ff.net.2`` and ``to_out.0`` are
``net_0_proj``/``net_2``/``to_out`` there; ``from_jax.py`` renames them).

The forward takes and returns NHWC latents [B, h, w, 4] like the JAX
``apply``; inside, the convolutions run NCHW. LoRA (flat dict, see
``nn/layers.py``) and P2P control are runtime inputs, so one module
serves the base lanes and the stacked concept lanes.

``forward(..., seq_group=g)`` runs the spatially split layout of the
multi-device stage 1: ``sample`` holds this rank's block of latent rows,
every conv, group norm and self-attention works across the group
(``nn/layers.py``, ``nn/attention.py``), and the eps of the same rows
comes back. The time embeddings are computed whole on every rank.

The conditioned paths add two inputs, as in the JAX ``apply``: a
ControlNet's residuals (``down_block_residuals``, added to the skips
after the down blocks, ``mid_block_residual`` after the mid block; NCHW,
the layout ``models/controlnet.py`` returns) and the IP-Adapter branch
(``ip_adapter``: one ``IPKV`` per attn2 in traversal order, over
``ip_context`` tokens scaled by ``ip_scale``).

DeepCache (Ma et al. 2023, arXiv 2312.00858; the JAX ``apply(...,
return_cache=True)``/``apply_shallow``): ``forward(..., return_cache=True)``
also returns the feature entering the last up block, and
``apply_shallow`` recomputes only the shallowest level (conv_in and
down_blocks[0] for fresh skips) and resumes from that feature through the
last up block and the head. At SDXL's geometry level 0 has no attention,
so a shallow step launches no attention kernel and applies no LoRA, IP or
P2P edit; a geometry whose level 0 has attention takes them there (the IP
layers of down block 0, then those of the last up block, the traversal
order's tail).

On a card, ``forward(..., graphed=True)`` replays a CUDA graph of the
plain forward (no option but ``lora``) per key: the inputs' shapes,
dtypes and device. A key's first call with given factors runs eagerly
(it makes their lazily fused groups), its second captures on the UNet's
own stream and memory pool, and later calls copy the sample, the
timestep and any new prompt rows into the graph's static inputs and
replay it. The graph reads the factors where the request keeps them and
holds them only weakly, so they go when the request drops them; new
factors at a key, or none after a graph whose factors are gone, are
captured anew and replace its graph: one capture a request. What the capture counted (K1's launches, the program's
counters) is counted again at each replay, so a replayed step counts
what an eager one does.
"""

from __future__ import annotations

import weakref
from typing import Optional

import torch
from torch import nn

from omg_tpu_torch.config import UNetConfig
from omg_tpu_torch.nn import layers
from omg_tpu_torch.nn.attention import IPKV, Attention
from omg_tpu_torch.ops import flash_attention as fa
from omg_tpu_torch.utils import profiling


class IPInputs:
    """The IP-Adapter branch of one forward: each attn2, in traversal
    order, takes the next of ``layers`` (the JAX ``_AttnCtx.ip_idx``)."""

    def __init__(self, layers_, context: torch.Tensor, scale: float):
        self._layers = iter(layers_)
        self.context = context
        self.scale = scale

    def take(self) -> IPKV:
        return next(self._layers)


class ResnetBlock(nn.Module):
    def __init__(self, in_ch, out_ch, temb_ch, groups, kw):
        super().__init__()
        self.norm1 = layers.GroupNorm(in_ch, groups, **kw)
        self.conv1 = layers.Conv2d(in_ch, out_ch, 3, **kw)
        self.time_emb_proj = layers.Linear(temb_ch, out_ch, **kw)
        self.norm2 = layers.GroupNorm(out_ch, groups, **kw)
        self.conv2 = layers.Conv2d(out_ch, out_ch, 3, **kw)
        self.conv_shortcut = (layers.Conv2d(in_ch, out_ch, 1, **kw)
                              if in_ch != out_ch else None)

    def forward(self, x, temb, seq=None):
        h = self.conv1(torch.nn.functional.silu(self.norm1(x, seq)), seq)
        t = self.time_emb_proj(torch.nn.functional.silu(temb))
        h = h + t[:, :, None, None].to(h.dtype)
        h = self.conv2(torch.nn.functional.silu(self.norm2(h, seq)), seq)
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return x + h


class FeedForward(nn.Module):
    """diffusers FeedForward: net.0 = GEGLU(proj), net.2 = out linear."""

    def __init__(self, dim, kw):
        super().__init__()
        geglu = nn.Module()
        geglu.proj = layers.Linear(dim, dim * 8, **kw)
        self.net = nn.ModuleList(
            [geglu, nn.Identity(), layers.Linear(dim * 4, dim, **kw)])

    def forward(self, x, lora):
        h = layers.geglu(self.net[0].proj, x, lora)
        return self.net[2](h, lora)


class BasicTransformerBlock(nn.Module):
    def __init__(self, dim, ctx_dim, head_dim, kw):
        super().__init__()
        heads = dim // head_dim
        self.norm1 = layers.LayerNorm(dim, **kw)
        self.attn1 = Attention(dim, num_heads=heads, head_dim=head_dim, **kw)
        self.norm2 = layers.LayerNorm(dim, **kw)
        self.attn2 = Attention(dim, context_dim=ctx_dim, num_heads=heads,
                               head_dim=head_dim, **kw)
        self.norm3 = layers.LayerNorm(dim, **kw)
        self.ff = FeedForward(dim, kw)

    def forward(self, x, context, lora, control, seq=None, ip=None):
        x = x + self.attn1(self.norm1(x), lora=lora, p2p=control,
                           seq_group=seq)
        kw = {} if ip is None else dict(ip=ip.take(), ip_context=ip.context,
                                        ip_scale=ip.scale)
        x = x + self.attn2(self.norm2(x), context, lora=lora, p2p=control,
                           **kw)
        return x + self.ff(self.norm3(x), lora)


class Transformer2DModel(nn.Module):
    def __init__(self, dim, depth, ctx_dim, head_dim, groups, kw):
        super().__init__()
        self.norm = layers.GroupNorm(dim, groups, **kw)
        self.proj_in = layers.Linear(dim, dim, **kw)
        self.transformer_blocks = nn.ModuleList(
            [BasicTransformerBlock(dim, ctx_dim, head_dim, kw)
             for _ in range(depth)])
        self.proj_out = layers.Linear(dim, dim, **kw)

    def forward(self, x, context, lora, control, seq=None, ip=None):
        b, c, hh, ww = x.shape
        h = self.norm(x, seq).permute(0, 2, 3, 1).reshape(b, hh * ww, c)
        h = self.proj_in(h, lora)
        for blk in self.transformer_blocks:
            h = blk(h, context, lora, control, seq, ip)
        h = self.proj_out(h, lora)
        return h.reshape(b, hh, ww, c).permute(0, 3, 1, 2) + x


def _sampler(ch, stride, kw):
    m = nn.Module()
    m.conv = layers.Conv2d(ch, ch, 3, stride=stride, **kw)
    return nn.ModuleList([m])


class UNet2DConditionModel(nn.Module):
    """SDXL UNet; ``forward`` is the JAX ``apply`` on the exact path."""

    def __init__(self, cfg: UNetConfig, device=None):
        super().__init__()
        self.cfg = cfg
        kw = dict(dtype=cfg.dtype, device=device)
        temb = cfg.time_embed_dim
        g = cfg.norm_num_groups
        chs = list(cfg.block_out_channels)
        n = len(chs)

        def pair(in_dim):
            m = nn.Module()
            m.linear_1 = layers.Linear(in_dim, temb, **kw)
            m.linear_2 = layers.Linear(temb, temb, **kw)
            return m

        def transformer(ch, depth):
            return Transformer2DModel(ch, depth, cfg.cross_attention_dim,
                                      cfg.attention_head_dim, g, kw)

        self.conv_in = layers.Conv2d(cfg.in_channels, chs[0], 3, **kw)
        self.time_embedding = pair(chs[0])
        self.add_embedding = pair(cfg.projection_class_embeddings_input_dim)

        self.down_blocks = nn.ModuleList()
        out_ch = chs[0]
        for i in range(n):
            in_ch, out_ch = out_ch, chs[i]
            depth = cfg.transformer_layers_per_block[i]
            blk = nn.Module()
            blk.resnets = nn.ModuleList(
                [ResnetBlock(in_ch if j == 0 else out_ch, out_ch, temb, g, kw)
                 for j in range(cfg.layers_per_block)])
            blk.attentions = nn.ModuleList(
                [transformer(out_ch, depth)
                 for _ in range(cfg.layers_per_block)] if depth else [])
            if i < n - 1:
                blk.downsamplers = _sampler(out_ch, 2, kw)
            self.down_blocks.append(blk)

        mid_ch, mid_depth = chs[-1], cfg.transformer_layers_per_block[-1]
        self.mid_block = nn.Module()
        self.mid_block.resnets = nn.ModuleList(
            [ResnetBlock(mid_ch, mid_ch, temb, g, kw) for _ in range(2)])
        self.mid_block.attentions = nn.ModuleList(
            [transformer(mid_ch, mid_depth)] if mid_depth else [])

        rev = chs[::-1]
        rev_depth = list(cfg.transformer_layers_per_block)[::-1]
        self.up_blocks = nn.ModuleList()
        out_ch = rev[0]
        for i in range(n):
            prev_out, out_ch = out_ch, rev[i]
            in_ch = rev[min(i + 1, n - 1)]
            blk = nn.Module()
            blk.resnets = nn.ModuleList()
            for j in range(cfg.layers_per_block + 1):
                skip_ch = in_ch if j == cfg.layers_per_block else out_ch
                res_in = prev_out if j == 0 else out_ch
                blk.resnets.append(
                    ResnetBlock(res_in + skip_ch, out_ch, temb, g, kw))
            blk.attentions = nn.ModuleList(
                [transformer(out_ch, rev_depth[i])
                 for _ in range(cfg.layers_per_block + 1)]
                if rev_depth[i] else [])
            if i < n - 1:
                blk.upsamplers = _sampler(out_ch, 1, kw)
            self.up_blocks.append(blk)

        self.conv_norm_out = layers.GroupNorm(chs[0], g, **kw)
        self.conv_out = layers.Conv2d(chs[0], cfg.out_channels, 3, **kw)
        layers.set_lora_keys(self)

    def time_embeddings(self, timestep, text_embeds: torch.Tensor,
                        time_ids: torch.Tensor) -> torch.Tensor:
        return time_embeddings(self, self.cfg, timestep, text_embeds,
                               time_ids)

    @profiling.spanned("unet", timed=True)
    def forward(self, sample: torch.Tensor, timestep,
                encoder_hidden_states: torch.Tensor, *,
                text_embeds: torch.Tensor, time_ids: torch.Tensor,
                lora: Optional[dict] = None, control=None,
                seq_group=None, down_block_residuals=None,
                mid_block_residual: Optional[torch.Tensor] = None,
                ip_adapter=None, ip_context: Optional[torch.Tensor] = None,
                ip_scale: float = 1.0, return_cache: bool = False,
                graphed: bool = False):
        """sample: [B, h, w, 4] NHWC latents -> eps prediction, same shape.
        ``seq_group``: sample is this rank's block of rows of the latent
        (``parallel.comm.Group``, equal blocks in group order).
        ``down_block_residuals``/``mid_block_residual``: ControlNet
        residuals, NCHW. ``ip_adapter``: a sequence of ``IPKV``, one per
        attn2 (``num_cross_attention_layers``), with ``ip_context``
        [B, T, cross_attention_dim]. ``return_cache``: (eps, the DeepCache
        feature entering the last up block, NCHW ``cache_shape``).
        ``graphed``: the plain forward of CUDA tensors with ``lora`` (a
        ``layers.LoraFactors`` or None), replayed from its key's CUDA graph
        (module docstring); the other options above do not reach it."""
        if graphed:
            return _GRAPHS.setdefault(self, _Graphs()).run(
                self, timestep,
                (sample, encoder_hidden_states, text_embeds, time_ids), lora)
        return self._forward(
            sample, timestep, encoder_hidden_states, text_embeds=text_embeds,
            time_ids=time_ids, lora=lora, control=control,
            seq_group=seq_group, down_block_residuals=down_block_residuals,
            mid_block_residual=mid_block_residual, ip_adapter=ip_adapter,
            ip_context=ip_context, ip_scale=ip_scale,
            return_cache=return_cache)

    def _forward(self, sample: torch.Tensor, timestep,
                 encoder_hidden_states: torch.Tensor, *,
                 text_embeds: torch.Tensor, time_ids: torch.Tensor,
                 lora: Optional[dict] = None, control=None,
                 seq_group=None, down_block_residuals=None,
                 mid_block_residual: Optional[torch.Tensor] = None,
                 ip_adapter=None, ip_context: Optional[torch.Tensor] = None,
                 ip_scale: float = 1.0, return_cache: bool = False):
        """The body of ``forward``, outside its span."""
        ctx, seq = encoder_hidden_states, seq_group
        ip = None
        if ip_adapter is not None and ip_context is not None:
            ip = IPInputs(ip_adapter, ip_context.to(self.cfg.dtype), ip_scale)
        temb = self.time_embeddings(timestep, text_embeds, time_ids)
        x = self.conv_in(sample.permute(0, 3, 1, 2), seq)
        residuals = [x]
        for blk in self.down_blocks:
            for ri, res in enumerate(blk.resnets):
                x = res(x, temb, seq)
                if len(blk.attentions):
                    x = blk.attentions[ri](x, ctx, lora, control, seq, ip)
                residuals.append(x)
            if hasattr(blk, "downsamplers"):
                x = blk.downsamplers[0].conv(x, seq)
                residuals.append(x)
        if down_block_residuals is not None:
            residuals = [r + c.to(r.dtype)
                         for r, c in zip(residuals, down_block_residuals)]

        mid = self.mid_block
        x = mid.resnets[0](x, temb, seq)
        if len(mid.attentions):
            x = mid.attentions[0](x, ctx, lora, control, seq, ip)
        x = mid.resnets[1](x, temb, seq)
        if mid_block_residual is not None:
            x = x + mid_block_residual.to(x.dtype)

        cache = None
        for bi, blk in enumerate(self.up_blocks):
            if bi == len(self.up_blocks) - 1:
                cache = x
            x = self._up_block(blk, x, residuals, temb, ctx, lora, control,
                               seq, ip)
            if hasattr(blk, "upsamplers"):
                x = blk.upsamplers[0].conv(layers.upsample_nearest_2x(x), seq)
        out = self._head(x, seq)
        return (out, cache) if return_cache else out

    def _up_block(self, blk, x, residuals, temb, ctx, lora, control, seq,
                  ip):
        for ri, res in enumerate(blk.resnets):
            x = torch.cat([x, residuals.pop().to(x.dtype)], dim=1)
            x = res(x, temb, seq)
            if len(blk.attentions):
                x = blk.attentions[ri](x, ctx, lora, control, seq, ip)
        return x

    def _head(self, x, seq):
        x = torch.nn.functional.silu(self.conv_norm_out(x, seq))
        return self.conv_out(x, seq).permute(0, 2, 3, 1)

    @profiling.spanned("unet", timed=True)
    def apply_shallow(self, sample: torch.Tensor, timestep,
                      encoder_hidden_states: torch.Tensor, *,
                      text_embeds: torch.Tensor, time_ids: torch.Tensor,
                      cache: torch.Tensor, lora: Optional[dict] = None,
                      control=None, seq_group=None, ip_adapter=None,
                      ip_context: Optional[torch.Tensor] = None,
                      ip_scale: float = 1.0) -> torch.Tensor:
        """The DeepCache shallow forward (branch 0): conv_in and
        down_blocks[0] for fresh skips, then the last up block from
        ``cache`` (a full forward's ``return_cache`` feature) and the
        head. Fed the cache of a full forward at the same (sample, t), it
        gives that forward's eps: the approximation is only the cache's
        age. ``seq_group``: the spatial split, as ``forward``'s (the cache
        holds the same rows)."""
        ctx, seq = encoder_hidden_states, seq_group
        ip = None
        last = self.up_blocks[-1]
        if ip_adapter is not None and ip_context is not None:
            ip_layers = list(ip_adapter)
            first = self.down_blocks[0]
            n_first = sum(len(a.transformer_blocks) for a in first.attentions)
            n_last = sum(len(a.transformer_blocks) for a in last.attentions)
            # down block 0's attn2 layers lead the traversal order, the
            # last up block's end it
            ip = IPInputs(ip_layers[:n_first]
                          + ip_layers[len(ip_layers) - n_last:],
                          ip_context.to(self.cfg.dtype), ip_scale)
        temb = self.time_embeddings(timestep, text_embeds, time_ids)
        x = self.conv_in(sample.permute(0, 3, 1, 2), seq)
        residuals = [x]
        blk = self.down_blocks[0]
        for ri, res in enumerate(blk.resnets):
            x = res(x, temb, seq)
            if len(blk.attentions):
                x = blk.attentions[ri](x, ctx, lora, control, seq, ip)
            residuals.append(x)
        x = self._up_block(last, cache, residuals, temb, ctx, lora, control,
                           seq, ip)
        return self._head(x, seq)


def time_embeddings(model: nn.Module, cfg: UNetConfig, timestep,
                    text_embeds: torch.Tensor,
                    time_ids: torch.Tensor) -> torch.Tensor:
    """Timestep + SDXL text_time micro-conditioning -> [B, temb] through
    ``model``'s ``time_embedding``/``add_embedding`` MLPs (the UNet's or a
    ControlNet's). The sinusoids run in fp32 and are cast to the model
    dtype before the two MLPs, as in the JAX package. ``timestep``: a host
    number, filled on the device (no copy), or a 0-dim fp32 tensor on the
    device holding it (a CUDA graph's static input): the same bits."""
    b = text_embeds.shape[0]
    if isinstance(timestep, torch.Tensor):
        t = timestep.expand(b)
    else:
        t = torch.full((), float(timestep), dtype=torch.float32,
                       device=text_embeds.device).expand(b)
    t_emb = layers.timestep_embedding(t, cfg.block_out_channels[0])
    te = model.time_embedding
    temb = te.linear_2(torch.nn.functional.silu(
        te.linear_1(t_emb.to(cfg.dtype))))
    ids = time_ids.float().reshape(-1)
    id_emb = layers.timestep_embedding(
        ids, cfg.addition_time_embed_dim).reshape(b, -1)
    add = torch.cat([text_embeds.float(), id_emb], dim=-1)
    ae = model.add_embedding
    aemb = ae.linear_2(torch.nn.functional.silu(
        ae.linear_1(add.to(cfg.dtype))))
    return temb + aemb


class _Graphs:
    """One UNet's graphed forwards: per key the graph of the factors it
    last ran, or a ``_Seen`` after their eager first call; and the memory
    pool and the stream their captures share."""

    def __init__(self):
        self.by_key: dict = {}
        self.pool = self.stream = None

    def run(self, unet: UNet2DConditionModel, timestep, inputs: tuple,
            lora: Optional[layers.LoraFactors]) -> torch.Tensor:
        """The plain forward of ``inputs`` (sample, context, text embeds,
        time ids) at ``timestep`` with ``lora``: eager on its key's first
        call with these factors, captured on its second, replayed from
        then on."""
        key = tuple((tuple(x.shape), x.dtype) for x in inputs) + (
            inputs[0].device,)
        g = self.by_key.get(key)
        if g is None or g.lora() is not lora:
            self.by_key[key] = _Seen(lora, g)
            sample, ctx, text_embeds, time_ids = inputs
            return unet._forward(sample, timestep, ctx,
                                 text_embeds=text_embeds, time_ids=time_ids,
                                 lora=lora)
        if isinstance(g, _Seen):
            g = self.by_key[key] = _Graph(unet, self, timestep, inputs, lora)
            profiling.count("graph.captures")
        out = g.replay(timestep, inputs)
        profiling.count("graph.replays")
        return out


# Weakly keyed by the UNet: its graphs go with it, and a copy of it starts
# with none.
_GRAPHS: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


_GONE = object()


def _ref(lora: Optional[layers.LoraFactors]):
    """A weak reference to a request's factors (or to None), which gives
    them, None, or ``_GONE`` once they are freed: a graph that reads them
    never keeps them alive, and one whose factors are gone serves no later
    call, not even one without factors."""
    if lora is None:
        return lambda: None
    ref = weakref.ref(lora)
    return lambda: _GONE if (f := ref()) is None else f


class _Seen:
    """A key after its eager first call with ``lora``. It keeps the
    key's previous graph until the capture replaces it: a memory pool
    whose graphs are all gone takes no capture until the allocator has
    freed it."""

    def __init__(self, lora: Optional[layers.LoraFactors], prev):
        self.lora = _ref(lora)
        self.prev = prev.prev if isinstance(prev, _Seen) else prev


class _Graph:
    """One captured plain forward: its static inputs (a 0-dim fp32
    timestep, the sample, the prompt rows), a weak reference to the
    factors it reads (``_ref``), its output, and what its capture
    recorded for each replay to count: K1's launches and the program's
    counters."""

    def __init__(self, unet: UNet2DConditionModel, graphs: _Graphs,
                 timestep, inputs: tuple,
                 lora: Optional[layers.LoraFactors]):
        # normal tensors, so that a later call outside inference mode can
        # write them; no autograd in the captured work
        with torch.inference_mode(False), torch.no_grad():
            self.t = torch.full((), float(timestep), dtype=torch.float32,
                                device=inputs[0].device)
            self.inputs = tuple(x.clone() for x in inputs)
            self.src = inputs[1:]       # the prompt rows last copied in
            self.lora = _ref(lora)
            with profiling.recorded() as self.counts:
                self.out, self.k1 = self._capture(unet, graphs)

    def _capture(self, unet: UNet2DConditionModel, graphs: _Graphs) -> tuple:
        """-> (the output buffer, K1's launches): the forward's body
        captured into ``self.graph`` in the UNet's pool (nothing runs),
        its launches recorded and left uncounted until a replay runs
        them. The capture stream is the UNet's own, so that its cuBLAS
        workspace is made once; unlike ``torch.cuda.graph``, nothing
        synchronizes or empties the allocator's cache, which the
        request's later allocations would then make again."""
        sample, ctx, text_embeds, time_ids = self.inputs
        if graphs.pool is None:
            graphs.pool = torch.cuda.graph_pool_handle()
            graphs.stream = torch.cuda.Stream(sample.device)
        self.graph = torch.cuda.CUDAGraph()
        with fa.recorded() as k1, torch.cuda.stream(graphs.stream):
            self.graph.capture_begin(graphs.pool,
                                     capture_error_mode="thread_local")
            try:
                out = unet._forward(sample, self.t, ctx,
                                    text_embeds=text_embeds,
                                    time_ids=time_ids, lora=self.lora())
            finally:
                self.graph.capture_end()
        return out, k1

    def replay(self, timestep, inputs: tuple) -> torch.Tensor:
        """The forward of ``inputs`` at ``timestep`` -> the output buffer."""
        self.inputs[0].copy_(inputs[0])
        self.t.fill_(float(timestep))
        if any(a is not b for a, b in zip(inputs[1:], self.src)):
            for buf, x in zip(self.inputs[1:], inputs[1:]):
                buf.copy_(x)
            self.src = inputs[1:]
        self.graph.replay()
        for launch in self.k1:
            fa.count_launch(*launch)
        for name, n in self.counts.items():
            profiling.count(name, n)
        return self.out


def init_params(generator: torch.Generator, cfg: UNetConfig,
                device=None) -> UNet2DConditionModel:
    """A UNet with random weights drawn from ``generator`` on ``device``
    (the generator's device when None)."""
    return layers.init_params(UNet2DConditionModel(
        cfg, device or generator.device), generator)


def cache_shape(cfg: UNetConfig, batch: int, h: int, w: int) -> tuple:
    """The DeepCache feature of an [batch, h, w, 4] latent, NCHW: the input
    of the last up block, at the latent's resolution with the channels of
    the second-shallowest level (the JAX ``cache_shape`` is its NHWC
    form)."""
    return (batch, cfg.block_out_channels[1], h, w)


def num_cross_attention_layers(cfg: UNetConfig) -> int:
    """Count of attn2 layers, traversal order."""
    depths = list(cfg.transformer_layers_per_block)
    return (cfg.layers_per_block * sum(depths) + depths[-1]
            + (cfg.layers_per_block + 1) * sum(depths))


def ip_file_order(cfg: UNetConfig) -> list:
    """The traversal index of each IP layer of an IP-Adapter file, in the
    file's order: diffusers' ``attn_processors``, which lists the down
    blocks' attn2, then the up blocks', then the mid block's
    (``UNet2DConditionModel`` registers ``up_blocks`` before
    ``mid_block``), where the forward takes down, mid, up."""
    depths = list(cfg.transformer_layers_per_block)
    n_down = cfg.layers_per_block * sum(depths)
    n_mid = depths[-1]
    n_up = (cfg.layers_per_block + 1) * sum(depths)
    return (list(range(n_down))
            + list(range(n_down + n_mid, n_down + n_mid + n_up))
            + list(range(n_down, n_down + n_mid)))


def init_ip_layers(generator: torch.Generator, cfg: UNetConfig,
                   device=None) -> nn.ModuleList:
    """Random IP-Adapter projections for every attn2 of a UNet of ``cfg``,
    in traversal order, drawn from ``generator`` on ``device`` (the
    generator's device when None)."""
    dev = device or generator.device
    chs, depths = cfg.block_out_channels, cfg.transformer_layers_per_block
    lpb = cfg.layers_per_block
    widths = ([ch for ch, d in zip(chs, depths) for _ in range(lpb * d)]
              + [chs[-1]] * depths[-1]
              + [ch for ch, d in zip(chs[::-1], depths[::-1])
                 for _ in range((lpb + 1) * d)])
    return layers.init_params(nn.ModuleList(
        [IPKV(cfg.cross_attention_dim, w, dtype=cfg.dtype, device=dev)
         for w in widths]), generator)
