"""CLIP text encoders, SDXL's text_encoder and text_encoder_2 (port of
``omg_tpu/models/clip.py``).

Submodule names follow the transformers state_dict. SDXL consumes the
penultimate hidden states of both encoders (concatenated 768 + 1280 =
2048 as cross-attention context) and the projected pooled EOS state of
encoder 2. The causal attention is masked, so it runs the plain path.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch import nn

from omg_tpu_torch.config import CLIPTextConfig
from omg_tpu_torch.nn import layers
from omg_tpu_torch.nn.attention import sdpa


class CLIPTextOutput(NamedTuple):
    last_hidden_state: torch.Tensor     # [B, 77, H] (final_layer_norm applied)
    penultimate: torch.Tensor           # [B, 77, H] hidden_states[-2]
    pooled: torch.Tensor                # [B, H] EOS-token pooled
    projected: Optional[torch.Tensor]   # [B, P] text_projection(pooled)


class EncoderLayer(nn.Module):
    def __init__(self, cfg: CLIPTextConfig, kw):
        super().__init__()
        d = cfg.hidden_size
        self.num_heads = cfg.num_heads
        self.act = cfg.hidden_act
        self.layer_norm1 = layers.LayerNorm(d, **kw)
        self.self_attn = nn.Module()
        for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
            setattr(self.self_attn, name, layers.Linear(d, d, **kw))
        self.layer_norm2 = layers.LayerNorm(d, **kw)
        self.mlp = nn.Module()
        self.mlp.fc1 = layers.Linear(d, cfg.intermediate_size, **kw)
        self.mlp.fc2 = layers.Linear(cfg.intermediate_size, d, **kw)

    def forward(self, x, mask, lora):
        a = self.self_attn
        h = self.layer_norm1(x)
        b, n, d = h.shape

        def split(t):
            return t.unflatten(-1, (self.num_heads, -1)).transpose(1, 2)

        out = sdpa(split(a.q_proj(h, lora)), split(a.k_proj(h, lora)),
                   split(a.v_proj(h, lora)), mask=mask)
        x = x + a.out_proj(out.transpose(1, 2).reshape(b, n, d), lora)
        h = self.mlp.fc1(self.layer_norm2(x), lora)
        h = layers.quick_gelu(h) if self.act == "quick_gelu" else layers.gelu(h)
        return x + self.mlp.fc2(h, lora)


class CLIPTextModel(nn.Module):
    """CLIPTextModel, or CLIPTextModelWithProjection when the config has a
    projection_dim."""

    def __init__(self, cfg: CLIPTextConfig, device=None):
        super().__init__()
        self.cfg = cfg
        kw = dict(dtype=cfg.dtype, device=device)
        d = cfg.hidden_size
        tm = self.text_model = nn.Module()
        tm.embeddings = nn.Module()
        tm.embeddings.token_embedding = layers.Embedding(cfg.vocab_size, d,
                                                         **kw)
        tm.embeddings.position_embedding = layers.Embedding(
            cfg.max_position_embeddings, d, **kw)
        tm.encoder = nn.Module()
        tm.encoder.layers = nn.ModuleList(
            [EncoderLayer(cfg, kw) for _ in range(cfg.num_layers)])
        tm.final_layer_norm = layers.LayerNorm(d, **kw)
        self.text_projection = (
            layers.Linear(d, cfg.projection_dim, bias=False, **kw)
            if cfg.projection_dim else None)
        layers.set_lora_keys(self)

    def forward(self, input_ids: torch.Tensor,
                lora: Optional[dict] = None) -> CLIPTextOutput:
        """input_ids: [B, 77] (BOS ... EOS, padded with EOS). ``lora``: the
        encoder's flat adapter dict (region-prompt personalization)."""
        tm = self.text_model
        emb = tm.embeddings
        x = emb.token_embedding(input_ids)
        n = x.shape[1]
        x = x + emb.position_embedding.weight[None, :n]
        causal = torch.triu(torch.full((n, n), float("-inf"),
                                       device=x.device), diagonal=1)
        penultimate = x
        for i, layer in enumerate(tm.encoder.layers):
            if i == self.cfg.num_layers - 1:
                penultimate = x
            x = layer(x, causal[None, None], lora)
        last = tm.final_layer_norm(x)
        # CLIP's EOS is the largest id: argmax finds the first EOS
        eos = torch.argmax(input_ids, dim=-1)
        pooled = last[torch.arange(last.shape[0], device=last.device), eos]
        projected = (self.text_projection(pooled)
                     if self.text_projection is not None else None)
        return CLIPTextOutput(last, penultimate, pooled, projected)


def init_params(generator: torch.Generator, cfg: CLIPTextConfig,
                device=None) -> CLIPTextModel:
    """A text encoder with random weights drawn from ``generator``."""
    return layers.init_params(CLIPTextModel(cfg, device), generator)
