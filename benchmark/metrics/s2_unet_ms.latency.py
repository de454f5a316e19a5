"""Device ms of a stage-2 UNet forward (3+2K lanes): the CUDA events of
the program's ``unet`` span under each stage-2 step of the window."""

from benchmark import program_trace as pt

NAME = "s2_unet_ms.latency"
UNIT = "ms"
LAYER = "models/unet.py stage 2"
MOVES = "image_s"


def unet_ms(r, step):
    vals = [pt.device_s(u) for u in r.children(step, "unet")]
    if not vals or any(v is None for v in vals):
        return None
    return 1e3 * sum(vals)


def read(rec):
    return pt.per_step(rec, "omg.generate", "stage2", unet_ms)
