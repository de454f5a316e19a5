"""Both decodes' seconds per request (GenerationResult.timings)."""

from benchmark import readers

NAME = "decode_s.latency"
UNIT = "s"
LAYER = "models/vae.py decode"
MOVES = "image_s"


def read(rec):
    return readers.mean_timing(rec, "decode")
