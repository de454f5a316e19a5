"""% of the window's stage-1 steps whose forward ran eagerly on the card
because stage 1's CUDA graphs were refused (a base ControlNet, or
DeepCache): the steps with the program's ``graph.eager`` counter under
them. None where no kept record of the root counts ``graph.eager``,
``graph.captures`` or ``graph.replays`` (a program that counts none of
them)."""

from omg_tpu_torch.utils import profiling

from benchmark import program_trace as pt

NAME = "s1_eager_steps.pose"
UNIT = "%"
LAYER = "pipelines/multiconcept.py stage 1"
MOVES = "image_s"
ROOT = "omg.generate"
KEYS = ("graph.eager", "graph.captures", "graph.replays")


def read(rec):
    records = pt.window(rec, ROOT)
    if records is None:
        return None
    kept = [r for r in list(profiling.REQUESTS) if r.root.name == ROOT]
    if not any(k in s.counters for r in kept for s in r.spans for k in KEYS):
        return None
    steps = [(r, s) for r in records for s in pt.phase_steps(r, "stage1")]
    if not steps:
        return None
    eager = sum(1 for r, s in steps if r.total(s, "graph.eager"))
    return 100.0 * eager / len(steps)
