"""The whole generation's model FLOPs over the window, as a share of the bf16 dense peak."""

from benchmark import readers

NAME = "gen_mfu.batch"
UNIT = "%"
LAYER = "model step"
MOVES = "images_per_min"


def read(rec):
    return readers.mfu(rec)
