"""Device ms of the IdentityNet over the concept lanes in a stage-2 step:
the CUDA events of the program's timed ``controlnet`` span under each
stage-2 step of the window (none where the span is untimed)."""

from benchmark import program_trace as pt

NAME = "s2_identitynet_ms.iid"
UNIT = "ms"
LAYER = "models/controlnet.py IdentityNet"
MOVES = "image_s"


def identitynet_ms(r, step):
    vals = [pt.device_s(c) for c in r.children(step, "controlnet")]
    if not vals or any(v is None for v in vals):
        return None
    return 1e3 * sum(vals)


def read(rec):
    return pt.per_step(rec, "omg.generate", "stage2", identitynet_ms)
