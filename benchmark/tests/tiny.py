"""A temporary copy of the benchmark with tiny cells, for CPU tests.

``tree(tmp)`` copies ``benchmark/`` and ``BENCHMARK.json`` under ``tmp``
and adds, as new files and new entries only, a tiny configuration of each
entry (SDXL's structure at widths a CPU runs in seconds, fp32) and their
cells, the way a later change adds a cell.
"""

from __future__ import annotations

import copy
import json
import pathlib
import shutil

REPO = pathlib.Path(__file__).resolve().parents[2]
TINY_CELLS = {"tiny_omg": "omg_lora2_sdxl", "tiny_t2i": "sdxl_lora1_t2i"}
TRAFFIC = {"tiny_omg": "omg_two_concept_closed_loop",
           "tiny_t2i": "t2i_batch4_closed_loop"}
ENTRY = {"tiny_omg": "omg_generate", "tiny_t2i": "t2i_batch"}
LIMITS = {c: {"eps_gap": 1e-3, "step_gap": 1e-3, "decode_gap_levels": 0.5}
          for c in ("tiny_omg", "tiny_t2i")}


def tiny_config(base: dict) -> dict:
    cfg = copy.deepcopy(base)
    cfg["name"] = "tiny_" + base["name"]
    cfg["unet"].update(
        sample_size=8, block_out_channels=[32, 64],
        down_block_types=["DownBlock2D", "CrossAttnDownBlock2D"],
        up_block_types=["CrossAttnUpBlock2D", "UpBlock2D"],
        layers_per_block=1, transformer_layers_per_block=[1, 1],
        attention_head_dim=[4, 8], cross_attention_dim=48,
        addition_time_embed_dim=8, projection_class_embeddings_input_dim=64,
        norm_num_groups=8)
    cfg["vae"].update(block_out_channels=[8, 8, 16, 16], layers_per_block=1,
                      norm_num_groups=8, sample_size=64)
    cfg["text_encoder"].update(vocab_size=1000, hidden_size=32,
                               intermediate_size=64, num_hidden_layers=2,
                               num_attention_heads=4)
    cfg["text_encoder_2"].update(vocab_size=1000, hidden_size=16,
                                 intermediate_size=32, num_hidden_layers=2,
                                 num_attention_heads=4, projection_dim=16)
    cfg["lora"]["rank"] = cfg["lora"]["alpha"] = 4
    cfg["pipeline"].update(height=64, width=64, num_steps=4)
    if "fusion_start" in cfg["pipeline"]:
        cfg["pipeline"]["fusion_start"] = 1
    cfg["precision"].update(unet="float32", text_encoders="float32")
    return cfg


def tree(tmp: pathlib.Path) -> pathlib.Path:
    """-> the copied ``benchmark`` folder, with the tiny cells added."""
    root = tmp / "benchmark"
    shutil.copytree(REPO / "benchmark", root,
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    for cell, base in TINY_CELLS.items():
        cfg = tiny_config(json.loads(
            (root / "configs" / f"{base}.json").read_text()))
        (root / "configs" / f"{cfg['name']}.json").write_text(json.dumps(cfg))
        (root / "workloads" / f"{cell}.json").write_text(json.dumps({
            "config": cfg["name"], "traffic": TRAFFIC[cell],
            "entry": ENTRY[cell], "chips": 1, "sample": 1,
            "limits": LIMITS[cell]}))
        bench["workloads"].append({"name": cell, "config": cfg["name"],
                                   "traffic": TRAFFIC[cell], "chips": 1,
                                   "why": "tiny"})
        for m in bench["end_to_end"] + bench["per_layer"]:
            if "workloads" in m and any(
                    w in m["workloads"] for w in bench_cells(base, bench)):
                m["workloads"].append(cell)
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


def bench_cells(config: str, bench: dict) -> list:
    return [w["name"] for w in bench["workloads"] if w["config"] == config]
