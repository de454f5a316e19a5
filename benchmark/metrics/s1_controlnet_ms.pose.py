"""The spatial ControlNet's span in a stage-1 step (its 2 CFG lanes):
the device ms between the CUDA events that the program's timed
``controlnet`` span records around each forward, summed under each
stage-1 step of the window (none where the span is untimed). Where the
host issues the forward's kernels more slowly than the card runs them,
as in the eager stage 1, the span's time holds the host's gaps too."""

from benchmark import program_trace as pt

NAME = "s1_controlnet_ms.pose"
UNIT = "ms"
LAYER = "models/controlnet.py spatial ControlNet"
MOVES = "image_s"


def controlnet_ms(r, step):
    vals = [pt.device_s(c) for c in r.children(step, "controlnet")]
    if not vals or any(v is None for v in vals):
        return None
    return 1e3 * sum(vals)


def read(rec):
    return pt.per_step(rec, "omg.generate", "stage1", controlnet_ms)
