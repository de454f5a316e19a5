"""The port's entry points place their work on the card unless the caller
asks for the CPU: with no device given, the mesh builders, the rank
launcher and the keypoint condition ask for CUDA, which a host without a
card refuses before any work starts."""

import numpy as np
import pytest
import torch

from omg_tpu_torch import instantid
from omg_tpu_torch.parallel import launch, mesh

from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse)


def _never_run(rank, device):
    raise AssertionError("no rank may start")


CALLS = {
    "make_mesh": lambda: mesh.make_mesh(),
    "make_latency_mesh": lambda: mesh.make_latency_mesh(2),
    "spawn": lambda: launch.spawn(_never_run, 2, backend="gloo"),
    "kps_image_to_cond": lambda: instantid.kps_image_to_cond(
        np.zeros((8, 8, 3), np.uint8)),
}


@pytest.mark.parametrize("name", list(CALLS))
def test_no_device_asks_for_the_card(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match=f"{name}: no CUDA device"):
        CALLS[name]()
