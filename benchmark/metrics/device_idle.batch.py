"""Share of the traced request's wall time with no operation on the device."""

from benchmark import readers

NAME = "device_idle.batch"
UNIT = "%"
LAYER = "device"
MOVES = "images_per_min"


def read(rec):
    return readers.device_idle(rec)
