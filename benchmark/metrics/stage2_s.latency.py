"""Stage 2's seconds per request (GenerationResult.timings)."""

from benchmark import readers

NAME = "stage2_s.latency"
UNIT = "s"
LAYER = "pipelines/multiconcept.py stage 2"
MOVES = "image_s"


def read(rec):
    return readers.mean_timing(rec, "stage2")
