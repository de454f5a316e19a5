"""The host's ms a stage-2 step waiting in blocking host-device operations
(the program's ``sync_wait_ns``, untraced window)."""

from benchmark import program_trace as pt

NAME = "s2_host_wait_ms.latency"
UNIT = "ms"
LAYER = "host-device sync"
MOVES = "image_s"


def read(rec):
    return pt.per_step(rec, "omg.generate", "stage2", pt.host_wait_ms)
