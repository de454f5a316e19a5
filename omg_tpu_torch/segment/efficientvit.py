"""EfficientViT-SAM image encoder, backbone + SamNeck (port of
``omg_tpu/segment/efficientvit.py``).

The reference's live segmentation encoder (efficientvit backbone.py:193-336
``EfficientViTLargeBackbone``, sam.py:103-192 ``SamNeck`` /
``EfficientViTSamImageEncoder``; xl1 geometry at sam.py:630-653). Each
stage's ``op_list`` holds modules that apply themselves (a stem conv, a
downsample, residual blocks), so the forward is a walk. Public layout
NHWC: [B, S, S, 3] normalized image -> [B, 64, 64, 256] embedding;
NCHW inside.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Optional, Sequence

import torch
from torch import nn

from omg_tpu_torch.segment import evit_ops as ops


@dataclasses.dataclass(frozen=True)
class EViTSamConfig:
    width_list: Sequence[int] = (32, 64, 128, 256, 512, 1024)
    depth_list: Sequence[int] = (1, 2, 2, 4, 6, 6)
    block_list: Sequence[str] = ("res", "fmb", "fmb", "fmb", "att@3", "att@3")
    expand_list: Sequence[int] = (1, 4, 4, 4, 4, 6)
    fewer_norm_list: Sequence[bool] = (False, False, False, False, True, True)
    qkv_dim: int = 32
    act: str = "gelu"
    # neck
    neck_fids: Sequence[str] = ("stage5", "stage4", "stage3")
    neck_in_channels: Sequence[int] = (1024, 512, 256)
    neck_width: int = 256
    neck_depth: int = 12
    neck_expand: int = 4
    neck_out_dim: int = 256
    neck_feature_hw: int = 64
    image_size: int = 1024
    dtype: torch.dtype = torch.float32


def xl1_config() -> EViTSamConfig:
    """EfficientViT-SAM-XL1 (reference: sam.py:630-653)."""
    return EViTSamConfig()


def xl0_config() -> EViTSamConfig:
    """EfficientViT-SAM-XL0 (reference: sam.py:604-627)."""
    return EViTSamConfig(depth_list=(0, 1, 1, 2, 3, 3), neck_depth=6)


def _l_series(depth_list, neck_depth) -> EViTSamConfig:
    # L-backbone defaults (reference: backbone.py:193-209) + SamNeck
    # fids/channels/middle for l0-l2 (reference: sam.py:547-601)
    return EViTSamConfig(
        width_list=(32, 64, 128, 256, 512),
        depth_list=depth_list,
        block_list=("res", "fmb", "fmb", "mb", "att"),
        expand_list=(1, 4, 4, 4, 6),
        fewer_norm_list=(False, False, False, True, True),
        neck_fids=("stage4", "stage3", "stage2"),
        neck_in_channels=(512, 256, 128),
        neck_depth=neck_depth,
        neck_expand=1,
        image_size=512,
    )


def l0_config() -> EViTSamConfig:
    """EfficientViT-SAM-L0 (reference: sam.py:547-563)."""
    return _l_series((1, 1, 1, 4, 4), 4)


def l1_config() -> EViTSamConfig:
    """EfficientViT-SAM-L1 (reference: sam.py:566-582)."""
    return _l_series((1, 1, 1, 6, 6), 8)


def l2_config() -> EViTSamConfig:
    """EfficientViT-SAM-L2 (reference: sam.py:585-601)."""
    return _l_series((1, 2, 2, 8, 8), 12)


# The reference zoo (sam_model_zoo.py:26-53). Signature = per-stage
# op_list lengths (1 stem/downsample + depth), which uniquely identifies
# each geometry in a state dict.
ZOO = {"l0": l0_config, "l1": l1_config, "l2": l2_config,
       "xl0": xl0_config, "xl1": xl1_config}


def _signature(cfg: EViTSamConfig) -> tuple:
    return tuple(1 + d for d in cfg.depth_list)


def infer_config(state: Mapping) -> Optional[EViTSamConfig]:
    """Zoo config from an encoder state dict's stage structure (its
    ``backbone.stages.N.op_list.M.*`` keys), or None if it matches no zoo
    geometry (including states without that structure)."""
    ops_per_stage: dict = {}
    for key in state:
        parts = key.split(".")
        if parts[:2] == ["backbone", "stages"] and parts[3:4] == ["op_list"]:
            sid, op = int(parts[2]), int(parts[4])
            ops_per_stage[sid] = max(ops_per_stage.get(sid, 0), op + 1)
    sig = tuple(ops_per_stage.get(i, 0) for i in range(len(ops_per_stage)))
    for make in ZOO.values():
        cfg = make()
        if _signature(cfg) == sig:
            return cfg
    return None


def tiny_config() -> EViTSamConfig:
    """CPU-testable miniature exercising every block type."""
    return EViTSamConfig(
        width_list=(8, 8, 16, 16, 32, 32),
        depth_list=(1, 1, 1, 1, 1, 1),
        expand_list=(1, 2, 2, 2, 2, 2),
        qkv_dim=8,
        neck_in_channels=(32, 32, 16),
        neck_width=16,
        neck_depth=1,
        neck_out_dim=16,
        neck_feature_hw=8,
        image_size=64,
    )


def _scales(block: str) -> tuple:
    return (3,) if block == "att@3" else (5,)


class _OpList(nn.Module):
    """A container whose ``op_list`` runs in order (a backbone stage)."""

    def __init__(self, ops_: Sequence[nn.Module]):
        super().__init__()
        self.op_list = nn.ModuleList(ops_)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for op in self.op_list:
            x = op(x)
        return x


def _stages(cfg: EViTSamConfig, device) -> list:
    a = cfg.act
    w0 = cfg.width_list[0]
    stem = [ops.ConvLayer(3, w0, 3, stride=2, act_func=a, device=device)]
    stem += [ops.ResidualBlock(ops.ResBlock(w0, act_func=a, device=device),
                               True) for _ in range(cfg.depth_list[0])]
    stages = [_OpList(stem)]
    cin = w0
    for sid in range(1, len(cfg.width_list)):
        w, block = cfg.width_list[sid], cfg.block_list[sid]
        fewer, expand = cfg.fewer_norm_list[sid], cfg.expand_list[sid]
        down = ops.FusedMBConv if block == "fmb" else ops.MBConv
        op_list = [ops.ResidualBlock(down(
            cin, w, expand * 4, stride=2, fewer_norm=fewer, act_func=a,
            device=device), False)]
        for _ in range(cfg.depth_list[sid]):
            if block.startswith("att"):
                op_list.append(ops.EfficientViTBlock(
                    w, dim=cfg.qkv_dim, scales=_scales(block), expand=expand,
                    act_func=a, device=device))
            else:
                body = ops.FusedMBConv if block == "fmb" else ops.MBConv
                op_list.append(ops.ResidualBlock(body(
                    w, w, expand, fewer_norm=fewer, act_func=a,
                    device=device), True))
        stages.append(_OpList(op_list))
        cin = w
    return stages


class Backbone(nn.Module):
    def __init__(self, cfg: EViTSamConfig, device=None):
        super().__init__()
        self.stages = nn.ModuleList(_stages(cfg, device))

    def forward(self, x: torch.Tensor) -> dict:
        """x [B, 3, S, S] -> {"stage0".."stageN"} NCHW features."""
        feats = {}
        for sid, stage in enumerate(self.stages):
            x = stage(x)
            feats[f"stage{sid}"] = x
        return feats


class SamNeck(nn.Module):
    """3-scale fusion -> the SAM embedding (reference: sam.py:103-173)."""

    def __init__(self, cfg: EViTSamConfig, device=None):
        super().__init__()
        self.fids = tuple(cfg.neck_fids)
        self.hw = (cfg.neck_feature_hw, cfg.neck_feature_hw)
        self.input_ops = nn.ModuleList(_OpList([ops.ConvLayer(
            c, cfg.neck_width, 1, device=device)])
            for c in cfg.neck_in_channels)
        self.middle = _OpList([ops.ResidualBlock(ops.FusedMBConv(
            cfg.neck_width, cfg.neck_width, cfg.neck_expand,
            act_func=cfg.act, device=device), True)
            for _ in range(cfg.neck_depth)])
        self.output_ops = nn.ModuleList([_OpList([ops.ConvLayer(
            cfg.neck_width, cfg.neck_out_dim, 1, norm=False, bias=True,
            device=device)])])

    def forward(self, feats: dict) -> torch.Tensor:
        acc = None
        for fid, op in zip(self.fids, self.input_ops):
            h = ops.bicubic_resize(op(feats[fid]), self.hw)
            acc = h if acc is None else acc + h
        return self.output_ops[0](self.middle(acc))


class EfficientViTSamImageEncoder(nn.Module):
    """Backbone, neck and the final ln2d (reference: sam.py:176-192)."""

    def __init__(self, cfg: EViTSamConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.backbone = Backbone(cfg, device)
        self.neck = SamNeck(cfg, device)
        self.norm = ops.LayerNorm2d(cfg.neck_out_dim, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x [B, S, S, 3] normalized -> [B, hw, hw, out_dim]."""
        feats = self.backbone(x.permute(0, 3, 1, 2))
        return self.norm(self.neck(feats)).permute(0, 2, 3, 1)


def init_params(generator: torch.Generator, cfg: EViTSamConfig,
                device=None) -> EfficientViTSamImageEncoder:
    """Random weights (the JAX package's scheme: convs N(0, 1/fan_in),
    zero biases, identity BatchNorms) from ``generator`` on ``device``
    (the generator's device when None)."""
    return ops.init_weights(
        EfficientViTSamImageEncoder(cfg, device or generator.device),
        generator, lambda m, name, p: p[0].numel() ** -0.5)
