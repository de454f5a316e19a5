"""DPT (Dense Prediction Transformer) monocular depth, the "Depth"
condition preprocessor (port of ``omg_tpu/models/dpt.py``).

A plain-ViT backbone (Intel/dpt-large-class checkpoints) feeding the
reassemble and fusion neck and the depth head, NCHW. Submodule names are
transformers' ``DPTForDepthEstimation`` keys, so a state dict loads with
``convert.copy_into`` (``convert.convert_dpt`` drops the final
``dpt.layernorm``, which depth estimation does not read, as the JAX
converter does). The reassemble "resize_up" is a k x k, stride-k
transposed conv (weight [in, out, k, k]); position embeddings are
resized bilinearly for an off-size input; the fusion stage and the head
upsample with ``segment/evit_ops.bilinear_resize(_ac)``, torch's own.

DPT runs in fp32, and its attention keeps the plain form at every size:
K1 takes bf16 tensors, and an input of 512² or more (1025 tokens and up)
would pass its shape gate (``ops/flash_attention.use_flash``).

The convolutions skip cuDNN and TF32 on the card (``layers.conv_fp32``,
per call: PyTorch's im2col and an fp32 GEMM). With TF32 off,
cuDNN's heuristics took 146 ms of a 202 ms forward and a 16 GiB
workspace for the head's first conv (256 -> 128, 3x3, at 192²) on an
H100, where im2col and SGEMM run the whole forward in 25 ms with 0.8 GiB
(``tools/dpt_conv_probe.py``; PERF.md §6). The linears follow torch's
float32 matmul precision, full fp32 unless the process asks for TF32.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from omg_tpu_torch.nn import layers
from omg_tpu_torch.segment import evit_ops
from omg_tpu_torch.segment.evit_ops import (bicubic_resize, bilinear_resize,
                                            bilinear_resize_ac)


@dataclasses.dataclass(frozen=True)
class DPTConfig:
    hidden_size: int = 1024
    num_hidden_layers: int = 24
    num_attention_heads: int = 16
    intermediate_size: int = 4096
    image_size: int = 384
    patch_size: int = 16
    neck_hidden_sizes: Tuple[int, ...] = (256, 512, 1024, 1024)
    fusion_hidden_size: int = 256
    backbone_out_indices: Tuple[int, ...] = (5, 11, 17, 23)
    reassemble_factors: Tuple[float, ...] = (4.0, 2.0, 1.0, 0.5)
    layer_norm_eps: float = 1e-12
    dtype: torch.dtype = torch.float32

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads


def tiny_config() -> DPTConfig:
    return DPTConfig(hidden_size=32, num_hidden_layers=4,
                     num_attention_heads=2, intermediate_size=64,
                     image_size=64, patch_size=16,
                     neck_hidden_sizes=(16, 16, 32, 32),
                     fusion_hidden_size=16,
                     backbone_out_indices=(0, 1, 2, 3))


def _attention(q, k, v):
    """Softmax attention with fp32 scores (``nn/attention.sdpa``'s plain
    form)."""
    scale = q.shape[-1] ** -0.5
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    return torch.matmul(torch.softmax(scores, dim=-1).to(v.dtype), v)


class Conv(evit_ops.Conv):
    """``evit_ops.Conv`` (weight [out, in, k, k], optional bias) without
    cuDNN or TF32 on the card."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layers.conv_fp32(x, self.weight, self.bias, self.stride,
                                self.padding, cudnn=False)


class ConvTranspose(nn.Module):
    """A k x k, stride-k transposed conv: weight [in, out, k, k]."""

    def __init__(self, ch: int, k: int, *, dtype, device):
        super().__init__()
        self.weight = layers.param((ch, ch, k, k), dtype, device)
        self.bias = layers.param((ch,), dtype, device)
        self.k = k

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layers.conv_fp32(x, self.weight, self.bias, self.k,
                                cudnn=False, transposed=True)


class _Module(nn.Module):
    """A bare container (transformers' nesting of names)."""


class ViTLayer(nn.Module):
    def __init__(self, cfg: DPTConfig, kw: dict):
        super().__init__()
        d, ff = cfg.hidden_size, cfg.intermediate_size
        self.cfg = cfg
        self.layernorm_before = layers.LayerNorm(d, eps=cfg.layer_norm_eps,
                                                 **kw)
        self.attention = _Module()
        self.attention.attention = _Module()
        for name in ("query", "key", "value"):
            setattr(self.attention.attention, name, layers.Linear(d, d, **kw))
        self.attention.output = _Module()
        self.attention.output.dense = layers.Linear(d, d, **kw)
        self.layernorm_after = layers.LayerNorm(d, eps=cfg.layer_norm_eps,
                                                **kw)
        self.intermediate = _Module()
        self.intermediate.dense = layers.Linear(d, ff, **kw)
        self.output = _Module()
        self.output.dense = layers.Linear(ff, d, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, n, d = x.shape
        heads = self.cfg.num_attention_heads
        h = self.layernorm_before(x)
        a = self.attention.attention

        def split(t):
            return t.reshape(b, n, heads, -1).transpose(1, 2)

        o = _attention(split(a.query(h)), split(a.key(h)), split(a.value(h)))
        o = o.transpose(1, 2).reshape(b, n, d)
        x = x + self.attention.output.dense(o)
        h = self.layernorm_after(x)
        h = layers.gelu(self.intermediate.dense(h))
        return x + self.output.dense(h)


class DPT(nn.Module):
    """``DPTForDepthEstimation`` (plain ViT): pixels [B, 3, H, W],
    normalized, -> inverse depth [B, H, W]."""

    def __init__(self, cfg: DPTConfig, device=None):
        super().__init__()
        self.cfg = cfg
        kw = dict(dtype=cfg.dtype, device=device)
        d, f = cfg.hidden_size, cfg.fusion_hidden_size
        n_patch = (cfg.image_size // cfg.patch_size) ** 2

        def conv(cin, cout, k, stride=1, bias=True):
            return Conv(cin, cout, k, stride=stride, padding=k // 2, bias=bias,
                        **kw)

        self.dpt = _Module()
        emb = self.dpt.embeddings = _Module()
        emb.cls_token = layers.param((1, 1, d), cfg.dtype, device)
        emb.position_embeddings = layers.param((1, n_patch + 1, d),
                                               cfg.dtype, device)
        emb.patch_embeddings = _Module()
        emb.patch_embeddings.projection = Conv(
            3, d, cfg.patch_size, stride=cfg.patch_size, bias=True, **kw)
        self.dpt.encoder = _Module()
        self.dpt.encoder.layer = nn.ModuleList(
            [ViTLayer(cfg, kw) for _ in range(cfg.num_hidden_layers)])

        neck = self.neck = _Module()
        rs = neck.reassemble_stage = _Module()
        rs.readout_projects = nn.ModuleList(
            [nn.ModuleList([layers.Linear(2 * d, d, **kw)])
             for _ in cfg.neck_hidden_sizes])
        rs.layers = nn.ModuleList()
        for nh, factor in zip(cfg.neck_hidden_sizes, cfg.reassemble_factors):
            layer = _Module()
            layer.projection = conv(d, nh, 1)
            if factor > 1:
                layer.resize = ConvTranspose(nh, int(factor), **kw)
            elif factor < 1:
                layer.resize = conv(nh, nh, 3, stride=2)
            rs.layers.append(layer)
        neck.convs = nn.ModuleList([conv(nh, f, 3, bias=False)
                                    for nh in cfg.neck_hidden_sizes])
        neck.fusion_stage = _Module()
        neck.fusion_stage.layers = nn.ModuleList()
        for _ in cfg.neck_hidden_sizes:
            layer = _Module()
            layer.projection = conv(f, f, 1)
            for res in ("residual_layer1", "residual_layer2"):
                unit = _Module()
                unit.convolution1 = conv(f, f, 3)
                unit.convolution2 = conv(f, f, 3)
                setattr(layer, res, unit)
            neck.fusion_stage.layers.append(layer)
        self.head = _Module()
        self.head.head = nn.ModuleDict({"0": conv(f, f // 2, 3),
                                        "2": conv(f // 2, 32, 3),
                                        "4": conv(32, 1, 1)})

    def _embed(self, pixels: torch.Tensor) -> tuple:
        e = self.dpt.embeddings
        x = e.patch_embeddings.projection(pixels)
        b, d, gh, gw = x.shape
        tokens = x.flatten(2).transpose(1, 2)
        pos = e.position_embeddings.float()
        g_old = int(round(math.sqrt(pos.shape[1] - 1)))
        if (gh, gw) != (g_old, g_old):
            # transformers' _resize_pos_embed: bilinear, align_corners=False
            grid = pos[:, 1:].reshape(1, g_old, g_old, d).permute(0, 3, 1, 2)
            grid = bilinear_resize(grid, (gh, gw)).flatten(2).transpose(1, 2)
            pos = torch.cat([pos[:, :1], grid], dim=1)
        cls = e.cls_token.expand(b, 1, d).to(tokens.dtype)
        tokens = torch.cat([cls, tokens], dim=1)
        return tokens + pos.to(tokens.dtype), (gh, gw)

    def _reassemble(self, idx: int, hidden: torch.Tensor,
                    grid: tuple) -> torch.Tensor:
        gh, gw = grid
        rs = self.neck.reassemble_stage
        cls_tok, tokens = hidden[:, :1], hidden[:, 1:]
        # readout_type="project": cls beside every token, linear + GELU
        tokens = layers.gelu(rs.readout_projects[idx][0](torch.cat(
            [tokens, cls_tok.expand_as(tokens)], dim=-1)))
        b, n, d = tokens.shape
        x = tokens.transpose(1, 2).reshape(b, d, gh, gw)
        layer = rs.layers[idx]
        x = layer.projection(x)
        if hasattr(layer, "resize"):
            x = layer.resize(x)
        return x

    @staticmethod
    def _preact_res(unit, x: torch.Tensor) -> torch.Tensor:
        h = unit.convolution1(F.relu(x))
        h = unit.convolution2(F.relu(h))
        return x + h

    def _fusion(self, feats: list) -> torch.Tensor:
        """DPTFeatureFusionStage: deepest first, residual, 2x upsample."""
        fused = None
        for layer, feat in zip(self.neck.fusion_stage.layers, feats[::-1]):
            if fused is None:
                fused = feat
            else:
                if feat.shape[2:] != fused.shape[2:]:
                    feat = bilinear_resize(feat, fused.shape[2:])
                fused = fused + self._preact_res(layer.residual_layer1, feat)
            fused = self._preact_res(layer.residual_layer2, fused)
            fused = bilinear_resize_ac(
                fused, (fused.shape[2] * 2, fused.shape[3] * 2))
            fused = layer.projection(fused)
        return fused

    def forward(self, pixels: torch.Tensor) -> torch.Tensor:
        tokens, grid = self._embed(pixels.to(self.cfg.dtype))
        feats = []
        want = set(self.cfg.backbone_out_indices)
        x = tokens
        for i, layer in enumerate(self.dpt.encoder.layer):
            x = layer(x)
            if i in want:
                feats.append(x)
        feats = [self._reassemble(i, f, grid) for i, f in enumerate(feats)]
        feats = [conv(f) for conv, f in zip(self.neck.convs, feats)]
        fused = self._fusion(feats)
        head = self.head.head
        h = head["0"](fused)
        h = bilinear_resize_ac(h, (h.shape[2] * 2, h.shape[3] * 2))
        h = F.relu(head["2"](h))
        h = F.relu(head["4"](h))
        return h[:, 0]


@torch.no_grad()
def init_params(generator: torch.Generator, cfg: DPTConfig,
                device=None) -> DPT:
    """A DPT with random weights from ``generator`` on ``device`` (the
    generator's device when None), the JAX package's scheme: N(0,
    1/fan_in) linears and convs (the transposed convs' in and out widths
    are equal, so their fan-in is ``weight[0].numel()`` too), zero biases
    and class token, unit norms, N(0, 0.02²) position embeddings."""
    model = DPT(cfg, device or generator.device)

    def normal(w, std):
        w.copy_((torch.randn(w.shape, generator=generator, device=w.device,
                             dtype=torch.float32) * std).to(w.dtype))

    for name, p in model.named_parameters():
        if name.endswith("position_embeddings"):
            normal(p, 0.02)
        elif name.endswith("cls_token") or name.endswith("bias"):
            p.zero_()
        elif "layernorm" in name:
            p.fill_(1.0)
        else:
            normal(p, 1.0 / math.sqrt(p[0].numel()))
    return model


# DPT image-processor constants (DPTFeatureExtractor defaults).
IMAGE_MEAN = (0.5, 0.5, 0.5)
IMAGE_STD = (0.5, 0.5, 0.5)


class DepthEstimator:
    """Photo -> 3-channel min-max-normalized inverse-depth condition
    (reference: app.py get_depth, :340-357). The model and the bicubic
    resize run on the model's device, the normalization on the host."""

    def __init__(self, model: DPT, cfg: DPTConfig):
        self.model = model.eval()
        self.cfg = cfg
        self.device = next(model.parameters()).device

    @torch.no_grad()
    def __call__(self, image: np.ndarray,
                 out_size: Tuple[int, int] = (1024, 1024)) -> np.ndarray:
        """image: [H, W, 3] uint8 RGB -> [out_h, out_w, 3] uint8."""
        s = self.cfg.image_size
        resized = np.asarray(evit_ops.pil_resize_uint8(image, (s, s)),
                             np.float32) / 255.0
        x = (resized - np.asarray(IMAGE_MEAN)) / np.asarray(IMAGE_STD)
        x = torch.as_tensor(x.transpose(2, 0, 1)[None].copy(),
                            dtype=self.cfg.dtype, device=self.device)
        d = bicubic_resize(self.model(x)[:, None].float(), tuple(out_size))
        d = d[0, 0].cpu().numpy()
        dmin, dmax = d.min(), d.max()
        d = (d - dmin) / max(dmax - dmin, 1e-8)
        return np.clip(np.stack([d] * 3, -1) * 255.0, 0, 255).astype(np.uint8)


def config_from_json(hf_cfg: dict, dtype=torch.float32) -> DPTConfig:
    """A transformers DPT ``config.json`` -> DPTConfig (dpt-large values
    where a field is missing, as the JAX loader reads them)."""
    base = DPTConfig()
    return DPTConfig(
        hidden_size=hf_cfg.get("hidden_size", base.hidden_size),
        num_hidden_layers=hf_cfg.get("num_hidden_layers",
                                     base.num_hidden_layers),
        num_attention_heads=hf_cfg.get("num_attention_heads",
                                       base.num_attention_heads),
        intermediate_size=hf_cfg.get("intermediate_size",
                                     base.intermediate_size),
        image_size=hf_cfg.get("image_size", base.image_size),
        patch_size=hf_cfg.get("patch_size", base.patch_size),
        neck_hidden_sizes=tuple(hf_cfg.get("neck_hidden_sizes",
                                           base.neck_hidden_sizes)),
        fusion_hidden_size=hf_cfg.get("fusion_hidden_size",
                                      base.fusion_hidden_size),
        backbone_out_indices=tuple(hf_cfg.get("backbone_out_indices",
                                              base.backbone_out_indices)),
        dtype=dtype)


def load_depth_model(path: str, device="cuda") -> DepthEstimator:
    """A transformers DPT checkpoint directory (``config.json`` and
    ``model.safetensors`` or ``pytorch_model.bin``) -> the provider, the
    model on ``device`` (the card unless the caller asks for the CPU)."""
    from omg_tpu_torch import convert
    from omg_tpu_torch.loader import _load_folder_sd, _read_json
    device = layers.target_device(device, "load_depth_model")
    cfg = config_from_json(_read_json(path))
    return DepthEstimator(convert.convert_dpt(_load_folder_sd(path), cfg,
                                              device=device), cfg)
