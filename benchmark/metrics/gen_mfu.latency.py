"""The whole generation's model FLOPs over the window, as a share of the bf16 dense peak."""

from benchmark import readers

NAME = "gen_mfu.latency"
UNIT = "%"
LAYER = "model step"
MOVES = "image_s"


def read(rec):
    return readers.mfu(rec)
