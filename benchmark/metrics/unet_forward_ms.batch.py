"""Device ms per UNet forward: CUDA events around each forward of the traced request."""

from benchmark import readers

NAME = "unet_forward_ms.batch"
UNIT = "ms"
LAYER = "models/unet.py"
MOVES = "images_per_min"


def read(rec):
    return readers.unet_forward_ms(rec)
