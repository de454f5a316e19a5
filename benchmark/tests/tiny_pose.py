"""Tiny copies of the pose cell and the single-image t2i cell, added to
the tree of ``tiny_cells.tree`` as new files and entries (SDXL's
structure at widths a CPU runs in seconds, fp32)."""

from __future__ import annotations

import json
import pathlib

from benchmark.tests import tiny, tiny_cells

CELLS = {"tiny_pose": ("omg_lora2_pose_sdxl", "omg_pose_closed_loop",
                       "omg_pose", "omg2cn_latency_1024"),
         "tiny_t2i1": ("sdxl_lora1_t2i", "t2i_closed_loop", "t2i_single",
                       "t2i_lora1_latency_1024")}
LIMITS = {"tiny_pose": {"eps_gap": 1e-3, "step_gap": 1e-3,
                        "decode_gap_levels": 0.5, "cn_residual_gap": 1e-3,
                        "cn_cond_gap": 1e-3},
          "tiny_t2i1": {"eps_gap": 1e-3, "step_gap": 1e-3,
                        "decode_gap_levels": 0.5}}
UNET_KEYS = ("block_out_channels", "down_block_types", "layers_per_block",
             "transformer_layers_per_block", "attention_head_dim",
             "cross_attention_dim", "addition_time_embed_dim",
             "projection_class_embeddings_input_dim", "norm_num_groups")


def tiny_config(base: dict) -> dict:
    """``tiny.tiny_config``, and a ControlNet of the tiny UNet's encoder
    with a four-stage embedder (8x down to the latent), fp32."""
    cfg = tiny.tiny_config(base)
    if "controlnet" in cfg:
        cfg["controlnet"].update({k: cfg["unet"][k] for k in UNET_KEYS},
                                 conditioning_embedding_out_channels=[
                                     8, 8, 16, 16])
        cfg["precision"]["controlnet"] = "float32"
    return cfg


def tree(tmp: pathlib.Path) -> pathlib.Path:
    """``tiny_cells.tree`` with ``tiny_pose`` and ``tiny_t2i1`` added, each
    on the metrics its full-size cell lists."""
    root = tiny_cells.tree(tmp)
    bench = json.loads((tmp / "BENCHMARK.json").read_text())
    for cell, (base, mix, entry, real) in CELLS.items():
        cfg = tiny_config(json.loads(
            (root / "configs" / f"{base}.json").read_text()))
        cfg["name"] = f"{cell}_{base}"
        (root / "configs" / f"{cfg['name']}.json").write_text(json.dumps(cfg))
        (root / "workloads" / f"{cell}.json").write_text(json.dumps({
            "config": cfg["name"], "traffic": mix, "entry": entry,
            "chips": 1, "sample": 1, "limits": LIMITS[cell]}))
        bench["workloads"].append({"name": cell, "config": cfg["name"],
                                   "traffic": mix, "chips": 1,
                                   "why": "tiny"})
        for met in bench["end_to_end"] + bench["per_layer"]:
            if real in met.get("workloads", ()):
                met["workloads"].append(cell)
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    return root
