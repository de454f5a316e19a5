"""% of the window's ``sdxl.text_to_image`` denoise steps whose UNet
forward replayed a CUDA graph: the steps with the program's
``graph.replays`` counter under them. None where no kept record of the
root counts ``graph.captures`` or ``graph.replays`` (a program whose
text-to-image loop has no graphs)."""

from omg_tpu_torch.utils import profiling

from benchmark import program_trace as pt

NAME = "t2i_graph_steps.latency"
UNIT = "%"
LAYER = "models/unet.py"
MOVES = "image_s"
ROOT = "sdxl.text_to_image"
KEYS = ("graph.captures", "graph.replays")


def read(rec):
    records = pt.window(rec, ROOT)
    if records is None:
        return None
    kept = [r for r in list(profiling.REQUESTS) if r.root.name == ROOT]
    if not any(k in s.counters for r in kept for s in r.spans for k in KEYS):
        return None
    steps = [(r, s) for r in records for s in pt.phase_steps(r, "denoise")]
    if not steps:
        return None
    replayed = sum(1 for r, s in steps if r.total(s, "graph.replays"))
    return 100.0 * replayed / len(steps)
