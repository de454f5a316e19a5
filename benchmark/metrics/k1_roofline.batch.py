"""K1's share of its roofline in the traced request."""

from benchmark import readers

NAME = "k1_roofline.batch"
UNIT = "%"
LAYER = "ops/flash_attention.py K1"
MOVES = "images_per_min"


def read(rec):
    return readers.k1_roofline(rec)
