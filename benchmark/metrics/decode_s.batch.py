"""Device seconds of ``text_to_image``'s decode of the batch: the CUDA
events of the program's ``decode`` span, per request of the window."""

from benchmark import program_trace as pt

NAME = "decode_s.batch"
UNIT = "s"
LAYER = "models/vae.py decode"
MOVES = "images_per_min"


def read(rec):
    records = pt.window(rec, "sdxl.text_to_image")
    if records is None:
        return None
    vals = [pt.device_s(d) for r in records
            for d in r.children(r.root, "decode")]
    if not vals or any(v is None for v in vals):
        return None
    return sum(vals) / len(vals)
