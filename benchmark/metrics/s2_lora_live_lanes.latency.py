"""% of stage 2's LoRA lane deltas that apply an adapter: the program's
``lora.live_lane_deltas`` over ``lora.lane_deltas`` (the rest are the zero
pad of the base lanes)."""

from benchmark import program_trace as pt

NAME = "s2_lora_live_lanes.latency"
UNIT = "%"
LAYER = "lora.py lane stack"
MOVES = "image_s"


def read(rec):
    records = pt.window(rec, "omg.generate")
    if records is None:
        return None
    stages = [(r, p) for r in records for p in r.children(r.root, "stage2")]
    lanes = sum(r.total(p, "lora.lane_deltas") for r, p in stages)
    live = sum(r.total(p, "lora.live_lane_deltas") for r, p in stages)
    return 100.0 * live / lanes if lanes else None
