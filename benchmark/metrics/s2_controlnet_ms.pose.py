"""The ControlNet's span in a stage-2 step (its 3 base lanes), as
``s1_controlnet_ms.pose`` reads it in a stage-1 step."""

import pathlib
import runpy

from benchmark import program_trace as pt

NAME = "s2_controlnet_ms.pose"
UNIT = "ms"
LAYER = "models/controlnet.py spatial ControlNet"
MOVES = "image_s"

controlnet_ms = runpy.run_path(str(pathlib.Path(__file__).with_name(
    "s1_controlnet_ms.pose.py")))["controlnet_ms"]


def read(rec):
    return pt.per_step(rec, "omg.generate", "stage2", controlnet_ms)
