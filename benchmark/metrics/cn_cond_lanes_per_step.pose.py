"""Lanes whose condition image went through the ControlNet's
conditioning embedder per denoise step, over both stages: the program's
``controlnet.cond_lanes`` counter under the window's stage-1 and
stage-2 steps, over their number. (50 x 2 + 34 x 3) / 84 while every
forward embeds the image of each of its lanes; it falls only where the
condition is embedded once a request. None where no kept record of the
root counts it."""

from omg_tpu_torch.utils import profiling

from benchmark import program_trace as pt

NAME = "cn_cond_lanes_per_step.pose"
UNIT = "lanes"
LAYER = "models/controlnet.py spatial ControlNet"
MOVES = "image_s"
ROOT = "omg.generate"
KEY = "controlnet.cond_lanes"


def read(rec):
    records = pt.window(rec, ROOT)
    if records is None:
        return None
    kept = [r for r in list(profiling.REQUESTS) if r.root.name == ROOT]
    if not any(KEY in s.counters for r in kept for s in r.spans):
        return None
    steps = [(r, s) for r in records for phase in ("stage1", "stage2")
             for s in pt.phase_steps(r, phase)]
    if not steps:
        return None
    return sum(r.total(s, KEY) for r, s in steps) / len(steps)
