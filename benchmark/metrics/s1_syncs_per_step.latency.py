"""Blocking host-device operations per stage-1 step (the program's
``sync`` counter, under each ``step`` span of the window's requests)."""

from benchmark import program_trace as pt

NAME = "s1_syncs_per_step.latency"
UNIT = "syncs"
LAYER = "host-device sync"
MOVES = "image_s"


def read(rec):
    return pt.per_step(rec, "omg.generate", "stage1", pt.syncs)
