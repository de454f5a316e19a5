"""Tiny copies of the InstantID and the batched OMG cells, added to the
tree of ``tiny.tree`` as new files and entries (SDXL's structure at
widths a CPU runs in seconds, fp32)."""

from __future__ import annotations

import json
import pathlib

from benchmark.tests import tiny

CELLS = {"tiny_iid": ("omg_instantid_sdxl", "omg_instantid_closed_loop",
                      "omg_instantid"),
         "tiny_batch": ("omg_lora2_sdxl", "omg_two_concept_batch4_closed_loop",
                        "omg_batch")}
LIMITS = {"tiny_iid": {"eps_gap": 1e-3, "step_gap": 1e-3,
                       "decode_gap_levels": 0.5, "region_eps_gap": 1e-3},
          "tiny_batch": {"eps_gap": 1e-3, "step_gap": 1e-3,
                         "decode_gap_levels": 0.5}}


def tiny_config(base: dict) -> dict:
    if "lora" not in base:        # tiny.tiny_config cuts a LoRA's rank
        cfg = tiny.tiny_config(dict(base, lora={}))
        del cfg["lora"]
    else:
        cfg = tiny.tiny_config(base)
    if "identitynet" in cfg:
        u = cfg["unet"]
        cfg["identitynet"].update(
            {k: u[k] for k in (
                "block_out_channels", "down_block_types", "layers_per_block",
                "transformer_layers_per_block", "attention_head_dim",
                "cross_attention_dim", "addition_time_embed_dim",
                "projection_class_embeddings_input_dim", "norm_num_groups")},
            conditioning_embedding_out_channels=[8, 8, 16, 16])
        cfg["resampler"].update(dim=32, depth=1, dim_head=8, heads=4,
                                num_queries=4, embedding_dim=16,
                                output_dim=48, ff_mult=2)
        cfg["precision"].update(identitynet="float32", ip_adapter="float32",
                                resampler="float32")
    return cfg


def tree(tmp: pathlib.Path) -> pathlib.Path:
    """``tiny.tree`` with ``tiny_iid`` and ``tiny_batch`` added."""
    root = tiny.tree(tmp)
    bench = json.loads((tmp / "BENCHMARK.json").read_text())
    for cell, (base, mix, entry) in CELLS.items():
        cfg = tiny_config(json.loads(
            (root / "configs" / f"{base}.json").read_text()))
        cfg["name"] = f"{cell}_{base}"
        (root / "configs" / f"{cfg['name']}.json").write_text(json.dumps(cfg))
        m = json.loads((root / "traffic" / f"{mix}.json").read_text())
        if "faces" in m:
            m["faces"]["embedding_dim"] = cfg["resampler"]["embedding_dim"]
        (root / "traffic" / f"{cell}_{mix}.json").write_text(json.dumps(m))
        (root / "workloads" / f"{cell}.json").write_text(json.dumps({
            "config": cfg["name"], "traffic": f"{cell}_{mix}",
            "entry": entry, "chips": 1, "sample": 1,
            "limits": LIMITS[cell]}))
        bench["workloads"].append({"name": cell, "config": cfg["name"],
                                   "traffic": f"{cell}_{mix}", "chips": 1,
                                   "why": "tiny"})
        real = {"tiny_iid": "omg2_iid_latency_1024",
                "tiny_batch": "omg2_batch4_1024"}[cell]
        for met in bench["end_to_end"] + bench["per_layer"]:
            if real in met.get("workloads", ()):
                met["workloads"].append(cell)
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    return root
