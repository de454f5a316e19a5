"""Share of the traced request's wall time with no operation on the device."""

from benchmark import readers

NAME = "device_idle.latency"
UNIT = "%"
LAYER = "device"
MOVES = "image_s"


def read(rec):
    return readers.device_idle(rec)
