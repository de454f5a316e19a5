"""SAM prompt encoder and mask decoder (port of
``omg_tpu/segment/sam_decoder.py``).

segment_anything's ``PromptEncoder`` (random-Fourier positional encoding,
box and point prompts) and ``MaskDecoder`` (two-way transformer,
``ConvTranspose2d`` upscaling, hypernetwork mask heads, IoU head), always
at their published width of 256. Submodule names follow the torch state
dict (``prompt_encoder.*``, ``mask_decoder.*``). The functions take the
modules and keep the JAX layouts: image embeddings and dense prompts
[B, h, w, 256], sparse prompts [B, T, 256], masks [B, 4, 4h, 4w].
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from omg_tpu_torch.nn import layers
from omg_tpu_torch.segment import evit_ops as ops

EMBED_DIM = 256
FEAT_HW = 64
NUM_MASK_TOKENS = 4


class PromptEncoder(nn.Module):
    def __init__(self, device=None):
        super().__init__()
        self.pe_layer = nn.Module()
        self.pe_layer.positional_encoding_gaussian_matrix = layers.param(
            (2, EMBED_DIM // 2), ops.F32, device)
        self.point_embeddings = nn.ModuleList(
            layers.Embedding(1, EMBED_DIM, device=device) for _ in range(4))
        self.not_a_point_embed = layers.Embedding(1, EMBED_DIM, device=device)
        self.no_mask_embed = layers.Embedding(1, EMBED_DIM, device=device)


def _pe_encode(prompt: PromptEncoder, coords01: torch.Tensor) -> torch.Tensor:
    """coords in [0, 1] -> [..., 256] Fourier features."""
    gauss = prompt.pe_layer.positional_encoding_gaussian_matrix
    c = 2.0 * math.pi * ((2.0 * coords01 - 1.0) @ gauss)
    return torch.cat([torch.sin(c), torch.cos(c)], dim=-1)


def dense_pe(prompt: PromptEncoder, hw: int = FEAT_HW) -> torch.Tensor:
    """[hw, hw, 256] positional grid for the image embedding."""
    dev = prompt.no_mask_embed.weight.device
    s = (torch.arange(hw, dtype=torch.float32, device=dev) + 0.5) / hw
    grid = torch.stack(torch.meshgrid(s, s, indexing="xy"), dim=-1)
    return _pe_encode(prompt, grid)


def encode_boxes(prompt: PromptEncoder, boxes: torch.Tensor,
                 input_size: float) -> torch.Tensor:
    """boxes [B, 4] xyxy in pixels -> sparse embeddings [B, 2, 256]."""
    coords = (boxes.reshape(-1, 2, 2) + 0.5) / input_size
    emb = _pe_encode(prompt, coords)
    corners = torch.stack([prompt.point_embeddings[2].weight[0],
                           prompt.point_embeddings[3].weight[0]])
    return emb + corners


def encode_points(prompt: PromptEncoder, points: torch.Tensor,
                  labels: torch.Tensor, input_size: float) -> torch.Tensor:
    """points [B, N, 2] pixel xy + labels [B, N] -> sparse [B, N+1, 256].

    SAM ``PromptEncoder._embed_points``: +0.5 pixel-centre shift, Fourier
    PE, then label embeddings (1 -> point_embeddings[1], 0 ->
    point_embeddings[0], -1 -> not_a_point_embed with the PE zeroed).
    With no box prompt SAM appends one (0, 0) / -1 padding point."""
    b = points.shape[0]
    points = torch.cat([points, points.new_zeros(b, 1, 2)], dim=1)
    labels = torch.cat([labels, -labels.new_ones(b, 1)], dim=1)
    emb = _pe_encode(prompt, (points + 0.5) / input_size)
    lab = labels[..., None]
    pe = prompt.point_embeddings
    labelled = emb + torch.where(lab == 1, pe[1].weight[0], pe[0].weight[0])
    return torch.where(lab == -1, prompt.not_a_point_embed.weight[0],
                       labelled)


def no_mask_dense(prompt: PromptEncoder, batch: int,
                  hw: int = FEAT_HW) -> torch.Tensor:
    """Dense embedding when no mask prompt is given (a broadcast view)."""
    return prompt.no_mask_embed.weight[0].expand(batch, hw, hw, EMBED_DIM)


# --------------------------------------------------------------------------
# Two-way transformer
# --------------------------------------------------------------------------

class Attention(nn.Module):
    """SAM decoder attention, 8 heads, projections downsampled by
    ``down``."""

    def __init__(self, down: int = 1, num_heads: int = 8, device=None):
        super().__init__()
        d = EMBED_DIM // down
        self.num_heads = num_heads
        self.q_proj = layers.Linear(EMBED_DIM, d, device=device)
        self.k_proj = layers.Linear(EMBED_DIM, d, device=device)
        self.v_proj = layers.Linear(EMBED_DIM, d, device=device)
        self.out_proj = layers.Linear(d, EMBED_DIM, device=device)

    def forward(self, q: torch.Tensor, k: torch.Tensor,
                v: torch.Tensor) -> torch.Tensor:
        def split(t):
            return t.unflatten(-1, (self.num_heads, -1)).transpose(1, 2)

        qh, kh, vh = (split(p(t)) for p, t in
                      ((self.q_proj, q), (self.k_proj, k), (self.v_proj, v)))
        scores = torch.matmul(qh.float(), kh.float().transpose(-1, -2))
        probs = torch.softmax(scores / qh.shape[-1] ** 0.5, dim=-1)
        out = torch.matmul(probs.to(vh.dtype), vh).transpose(1, 2)
        return self.out_proj(out.flatten(2))


class TwoWayAttentionBlock(nn.Module):
    def __init__(self, device=None):
        super().__init__()
        kw = dict(device=device)
        self.self_attn = Attention(1, **kw)
        self.norm1 = layers.LayerNorm(EMBED_DIM, **kw)
        self.cross_attn_token_to_image = Attention(2, **kw)
        self.norm2 = layers.LayerNorm(EMBED_DIM, **kw)
        self.mlp = nn.Module()
        self.mlp.lin1 = layers.Linear(EMBED_DIM, 2048, **kw)
        self.mlp.lin2 = layers.Linear(2048, EMBED_DIM, **kw)
        self.norm3 = layers.LayerNorm(EMBED_DIM, **kw)
        self.cross_attn_image_to_token = Attention(2, **kw)
        self.norm4 = layers.LayerNorm(EMBED_DIM, **kw)

    def forward(self, queries, keys, query_pe, key_pe, *,
                skip_first_layer_pe: bool):
        if skip_first_layer_pe:
            queries = self.self_attn(queries, queries, queries)
        else:
            q = queries + query_pe
            queries = queries + self.self_attn(q, q, queries)
        queries = self.norm1(queries)

        q, k = queries + query_pe, keys + key_pe
        queries = self.norm2(queries + self.cross_attn_token_to_image(
            q, k, keys))
        queries = self.norm3(queries + self.mlp.lin2(
            F.relu(self.mlp.lin1(queries))))

        q, k = queries + query_pe, keys + key_pe
        keys = self.norm4(keys + self.cross_attn_image_to_token(k, q,
                                                                queries))
        return queries, keys


class TwoWayTransformer(nn.Module):
    def __init__(self, device=None):
        super().__init__()
        self.layers = nn.ModuleList(TwoWayAttentionBlock(device)
                                    for _ in range(2))
        self.final_attn_token_to_image = Attention(2, device=device)
        self.norm_final_attn = layers.LayerNorm(EMBED_DIM, device=device)

    def forward(self, image_emb: torch.Tensor, image_pe: torch.Tensor,
                tokens: torch.Tensor) -> tuple:
        """image_emb [B, H, W, C] + tokens [B, T, C] -> (tokens', src')."""
        b, h, w, c = image_emb.shape
        keys = image_emb.reshape(b, h * w, c)
        key_pe = image_pe.reshape(1, h * w, c).to(keys.dtype)
        queries = tokens
        for i, blk in enumerate(self.layers):
            queries, keys = blk(queries, keys, tokens, key_pe,
                                skip_first_layer_pe=(i == 0))
        q, k = queries + tokens, keys + key_pe
        queries = self.norm_final_attn(
            queries + self.final_attn_token_to_image(q, k, keys))
        return queries, keys


# --------------------------------------------------------------------------
# Mask decoder
# --------------------------------------------------------------------------

class MLP(nn.Module):
    """Three linears with ReLU between them."""

    def __init__(self, d_in: int, hidden: int, d_out: int, device=None):
        super().__init__()
        self.layers = nn.ModuleList([
            layers.Linear(d_in, hidden, device=device),
            layers.Linear(hidden, hidden, device=device),
            layers.Linear(hidden, d_out, device=device)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i, lin in enumerate(self.layers):
            x = lin(x)
            if i < len(self.layers) - 1:
                x = F.relu(x)
        return x


class ConvTranspose2x(nn.Module):
    """ConvTranspose2d(k=2, s=2): weight [in, out, 2, 2]."""

    def __init__(self, cin: int, cout: int, device=None):
        super().__init__()
        self.weight = layers.param((cin, cout, 2, 2), ops.F32, device)
        self.bias = layers.param((cout,), ops.F32, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv_transpose2d(x, self.weight, self.bias, stride=2)


class MaskDecoder(nn.Module):
    def __init__(self, device=None):
        super().__init__()
        self.iou_token = layers.Embedding(1, EMBED_DIM, device=device)
        self.mask_tokens = layers.Embedding(NUM_MASK_TOKENS, EMBED_DIM,
                                            device=device)
        self.transformer = TwoWayTransformer(device)
        # segment_anything's Sequential(convT, LN2d, GELU, convT, GELU)
        self.output_upscaling = nn.ModuleDict({
            "0": ConvTranspose2x(EMBED_DIM, 64, device),
            "1": ops.LayerNorm2d(64, device=device),
            "3": ConvTranspose2x(64, 32, device)})
        self.output_hypernetworks_mlps = nn.ModuleList(
            MLP(EMBED_DIM, EMBED_DIM, 32, device)
            for _ in range(NUM_MASK_TOKENS))
        self.iou_prediction_head = MLP(EMBED_DIM, EMBED_DIM, NUM_MASK_TOKENS,
                                       device)


def decode_masks(decoder: MaskDecoder, prompt: PromptEncoder,
                 image_emb: torch.Tensor, sparse: torch.Tensor,
                 dense: torch.Tensor) -> tuple:
    """-> (masks [B, 4, 4h, 4w], iou_pred [B, 4]).

    Row 0 is the single-mask output; rows 1:4 are the multimask outputs
    the predictor selects from by IoU score."""
    b, h, w, _ = image_emb.shape
    base = torch.cat([decoder.iou_token.weight, decoder.mask_tokens.weight])
    tokens = torch.cat([base.expand(b, -1, -1), sparse.to(base.dtype)], dim=1)
    src = image_emb + dense.to(image_emb.dtype)
    hs, src_out = decoder.transformer(src, dense_pe(prompt, h), tokens)
    iou_out, mask_out = hs[:, 0], hs[:, 1:1 + NUM_MASK_TOKENS]

    u = decoder.output_upscaling
    up = src_out.transpose(1, 2).reshape(b, EMBED_DIM, h, w)
    up = F.gelu(u["1"](u["0"](up)))
    up = F.gelu(u["3"](up))                              # [B, 32, 4h, 4w]
    hyper = torch.stack([mlp(mask_out[:, i]) for i, mlp in
                         enumerate(decoder.output_hypernetworks_mlps)], dim=1)
    masks = torch.matmul(hyper, up.flatten(2)).view(b, NUM_MASK_TOKENS,
                                                    4 * h, 4 * w)
    return masks, decoder.iou_prediction_head(iou_out)


def _std(module: nn.Module, name: str, p: torch.Tensor) -> float:
    """The JAX package's scales: N(0, 1) Fourier matrix, N(0, 0.02^2)
    tables and upscaling kernels, N(0, 1/fan_in) linears."""
    if name.endswith("gaussian_matrix"):
        return 1.0
    if isinstance(module, (layers.Embedding, ConvTranspose2x)):
        return 0.02
    return p.shape[1] ** -0.5


def init_prompt_encoder(generator: torch.Generator,
                        device=None) -> PromptEncoder:
    return ops.init_weights(PromptEncoder(device or generator.device),
                            generator, _std)


def init_mask_decoder(generator: torch.Generator, device=None) -> MaskDecoder:
    return ops.init_weights(MaskDecoder(device or generator.device),
                            generator, _std)
