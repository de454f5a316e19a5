"""K1's share of its roofline in the traced request."""

from benchmark import readers

NAME = "k1_roofline.latency"
UNIT = "%"
LAYER = "ops/flash_attention.py K1"
MOVES = "image_s"


def read(rec):
    return readers.k1_roofline(rec)
