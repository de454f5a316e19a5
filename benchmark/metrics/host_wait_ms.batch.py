"""The host's ms a ``text_to_image`` step waiting in blocking host-device
operations (the program's ``sync_wait_ns`` under each ``denoise`` step of
the window); none without CUDA events (on the CPU every copy counts)."""

from benchmark import program_trace as pt

NAME = "host_wait_ms.batch"
UNIT = "ms"
LAYER = "host-device sync"
MOVES = "images_per_min"


def wait_ms(r, step):
    return None if step.device_ns is None else pt.host_wait_ms(r, step)


def read(rec):
    return pt.per_step(rec, "sdxl.text_to_image", "denoise", wait_ms)
