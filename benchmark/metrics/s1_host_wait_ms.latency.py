"""The host's ms a stage-1 step waiting in blocking host-device operations
(the program's ``sync_wait_ns``, untraced window)."""

from benchmark import program_trace as pt

NAME = "s1_host_wait_ms.latency"
UNIT = "ms"
LAYER = "host-device sync"
MOVES = "image_s"


def read(rec):
    return pt.per_step(rec, "omg.generate", "stage1", pt.host_wait_ms)
