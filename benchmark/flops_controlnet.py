"""The forwards a spatial ControlNet (OpenPose, canny, depth) runs in an
OMG request. Each is the IdentityNet's network
(``flops_instantid.identitynet_forward``: the UNet's encoder and mid
block, the conditioning embedder at pixel resolution, the zero convs)
with its cross-attention over the 77-token text context where the
IdentityNet reads 16 face tokens.
"""

from __future__ import annotations

TEXT_TOKENS = 77


def omg_lanes(p: dict) -> tuple:
    """(stage-1 lanes, stage-2 lanes) a request's ControlNet forwards run:
    2 CFG lanes at each of stage 1's steps, the 3 base lanes at each
    stage-2 step after the fusion start."""
    late = p["num_steps"] - p["fusion_start"] - 1
    return 2 * p["num_steps"], 3 * late
