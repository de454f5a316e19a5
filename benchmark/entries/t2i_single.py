"""``sdxl.text_to_image`` of one image a prompt, back to back: the plain
SDXL user's wait. ``t2i_batch``'s entry (its set-up, run, check and
count) at the mix's one image a request, so each step's forward runs 2
lanes [uncond, cond]."""

from __future__ import annotations

from benchmark.entries.t2i_batch import (  # noqa: F401 (the entry's API)
    check, flops, free, images, run, setup)


def unet_lanes(cfg: dict) -> list:
    return [2] * cfg["pipeline"]["num_steps"]
