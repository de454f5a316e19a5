"""% of stage 2's LoRA lane deltas that a GEMM accumulates into the
projection's product: the program's ``lora.gemm_accumulated`` over
``lora.lane_deltas`` (the rest are added as tensors of their own). None
where the program does not count ``lora.gemm_accumulated``."""

from benchmark import program_trace as pt

NAME = "s2_lora_in_gemm.latency"
UNIT = "%"
LAYER = "lora.py lane stack"
MOVES = "image_s"
KEY = "lora.gemm_accumulated"


def read(rec):
    records = pt.window(rec, "omg.generate")
    if records is None:
        return None
    if not any(KEY in s.counters for r in records for s in r.spans):
        return None
    stages = [(r, p) for r in records for p in r.children(r.root, "stage2")]
    lanes = sum(r.total(p, "lora.lane_deltas") for r, p in stages)
    in_gemm = sum(r.total(p, KEY) for r, p in stages)
    return 100.0 * in_gemm / lanes if lanes else None
