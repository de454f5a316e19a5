"""Faults planted in the program's spatial ControlNet under a cell's run,
each a patch of ``pipelines/multiconcept.py`` applied for the run and
undone after (``planted.planted``).

    python -m benchmark.tests.planted_pose --workload omg2cn_latency_1024 \
        --fault <name> --seeds 1,2 [--out planted.jsonl]

One JSON line per run: the fault, the seed, ``correct`` and the compared
numbers with their limits. Each fault in ``REQUIRED`` must read above a
limit: a ControlNet dropped from either stage or at half its scale
(``cn_residual_gap``, ``eps_gap``), a blank condition image
(``cn_cond_gap``: the residuals barely see the pose). The other images
(moved, channels swapped, in [-1, 1]) are further faults of the
condition path.
"""

from __future__ import annotations

import sys

import torch

from benchmark.tests import planted
from omg_tpu_torch.pipelines import multiconcept


def _without_base_controlnets(name: str) -> dict:
    """``multiconcept.<name>`` called with no base ControlNet."""
    fn = getattr(multiconcept, name)

    def dropped(*a, **k):
        return fn(*a, **dict(k, base_controlnets=()))
    return {name: dropped}


def _each_controlnet(change) -> dict:
    """Every ControlNet that ``_controlnet_residuals`` runs, changed by
    ``change``."""
    fn = multiconcept._controlnet_residuals

    def changed(cns, *a, **k):
        return fn([change(cn) for cn in cns], *a, **k)
    return {"_controlnet_residuals": changed}


def _condition(change) -> dict:
    """Every ControlNet's condition image (NHWC) replaced by ``change`` of
    it: blank, moved 8 rows down, its channels reversed, or in [-1, 1]."""
    return _each_controlnet(
        lambda cn: cn._replace(cond_image=change(cn.cond_image)))


FAULTS = {
    "controlnet_dropped_stage1":
        lambda: _without_base_controlnets("sample_stage1_cached"),
    "controlnet_dropped_stage2":
        lambda: _without_base_controlnets("sample_stage2_resumed"),
    "half_scale": lambda: _each_controlnet(
        lambda cn: cn._replace(scale=0.5 * cn.scale)),
    "blank_condition": lambda: _condition(torch.zeros_like),
    "shifted_condition": lambda: _condition(
        lambda c: torch.roll(c, 8, dims=1)),
    "swapped_channels": lambda: _condition(lambda c: c.flip(-1)),
    "signed_condition": lambda: _condition(lambda c: 2 * c - 1),
}
REQUIRED = ("controlnet_dropped_stage1", "controlnet_dropped_stage2",
            "half_scale", "blank_condition")


def main(argv=None) -> int:
    """``planted.main`` with these faults among its choices."""
    planted.FAULTS.update(FAULTS)
    return planted.main(argv)


if __name__ == "__main__":
    sys.exit(main())
