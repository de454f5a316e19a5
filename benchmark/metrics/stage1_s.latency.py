"""Stage 1's seconds per request (GenerationResult.timings)."""

from benchmark import readers

NAME = "stage1_s.latency"
UNIT = "s"
LAYER = "pipelines/multiconcept.py stage 1"
MOVES = "image_s"


def read(rec):
    return readers.mean_timing(rec, "stage1")
