"""The pose cell and the single-image t2i cell at a tiny size on the CPU:
sound runs correct, the fp8 reference not, and runs with the ControlNet
dropped from either stage or at half its scale, or with a blank pose
image, not correct; the
ControlNet's FLOPs against a hand count; the four ``.pose`` metrics on
fabricated records, and nothing where the program records nothing.
``test_reference_imports.py`` holds ``reference/pose.py`` to its imports,
and ``tests/port/test_torch_pose_reference.py`` the port to the reference
at 1e-4."""

import collections

import pytest
import torch

from benchmark import flops_controlnet as fc
from benchmark import flops_instantid as fli
from benchmark import run
from benchmark.tests import planted, planted_pose, readings, tiny_pose
from benchmark.tests.test_program_metrics import rec_of
from omg_tpu_torch.utils import profiling


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny_pose.tree(tmp_path_factory.mktemp("bench"))


def line(root, cell, seed=5, **kw):
    return run.run_cell(cell, seed, 0.0, False, device=torch.device("cpu"),
                        root=root, **kw)


@pytest.mark.parametrize("cell", list(tiny_pose.CELLS))
def test_sound_runs_are_correct(root, cell):
    out = line(root, cell)
    assert out["correct"] is True
    assert set(out["checks"]) == set(tiny_pose.LIMITS[cell])
    assert "image_s" in out["metrics"]


@pytest.mark.parametrize("cell", list(tiny_pose.CELLS))
def test_the_fp8_reference_is_not_correct(root, cell):
    (got,) = readings.readings(cell, [7], device=torch.device("cpu"),
                               root=root)
    assert got["correct"] is True
    assert got["fp8_reference_correct"] is False


@pytest.mark.parametrize("fault", planted_pose.REQUIRED)
def test_a_planted_controlnet_fault(root, fault):
    """The ControlNet dropped from stage 1 or from stage 2, or its
    residuals at half the configured scale: the residuals' gap reads above
    its limit; a blank condition image: the condition path's does."""
    with planted.planted(planted_pose.FAULTS[fault]()):
        out = line(root, "tiny_pose")
    assert out["correct"] is False
    shown = "cn_cond_gap" if fault == "blank_condition" else \
        "cn_residual_gap"
    assert out["checks"][shown]["value"] > out["checks"][shown]["limit"]


def test_controlnet_flops_match_hand_counts():
    """One lane of a tiny ControlNet (h x w = 4 x 6 latents) over 77 text
    tokens and over 16 face tokens (the IdentityNet's count)."""
    from benchmark.tests.test_flop_counts import tiny_unet

    conv = lambda co, ci, k, n: 2 * co * ci * k * k * n  # noqa: E731
    lin = lambda n, ci, co: 2 * n * ci * co  # noqa: E731
    hw, q, px = 24, 6, 64 * 24
    temb = 32

    def res(ci, co, n):
        return (conv(co, ci, 3, n) + conv(co, co, 3, n) + lin(1, temb, co)
                + (conv(co, ci, 1, n) if ci != co else 0))

    def tr(c, n, ctx):
        return 2 * lin(n, c, c) + (
            6 * lin(n, c, c) + 4 * n * n * c + 2 * lin(ctx, 12, c)
            + 4 * n * ctx * c + lin(n, c, 8 * c) + lin(n, 4 * c, c))

    def hand(ctx):
        f = lin(1, 8, temb) + 2 * lin(1, temb, temb) + lin(1, 20, temb)
        f += conv(2, 3, 3, px) + conv(2, 2, 3, px) + conv(4, 2, 3, px // 4)
        f += conv(4, 4, 3, px // 4) + conv(4, 4, 3, px // 16)
        f += conv(4, 4, 3, px // 16) + conv(8, 4, 3, hw) + conv(8, 8, 3, hw)
        f += conv(8, 4, 3, hw) + res(8, 8, hw) + conv(8, 8, 3, q)
        f += res(8, 16, q) + tr(16, q, ctx) + 2 * res(16, 16, q) + \
            tr(16, q, ctx)
        f += 2 * conv(8, 8, 1, hw) + conv(8, 8, 1, q) + conv(16, 16, 1, q)
        return f + conv(16, 16, 1, q)

    cn = dict(tiny_unet(), conditioning_channels=3,
              conditioning_embedding_out_channels=[2, 4, 4, 8])
    assert fli.identitynet_forward(cn, 4, 6, ctx_len=fc.TEXT_TOKENS) == \
        hand(77)
    assert fli.identitynet_forward(cn, 4, 6) == hand(16)
    # 2 lanes at each of 50 stage-1 steps, 3 at each of the 34 fused ones
    assert fc.omg_lanes({"num_steps": 50, "fusion_start": 15}) == (100, 102)


# ------------------------------------------------ the metrics, fabricated

STEPS, FUSION = 4, 1
POSE = ("s1_controlnet_ms.pose", "s2_controlnet_ms.pose",
        "s1_eager_steps.pose", "cn_cond_lanes_per_step.pose")


@pytest.fixture
def fresh_records(monkeypatch):
    monkeypatch.setattr(profiling, "REQUESTS", collections.deque(maxlen=64))


def record(eager=True, counted=True, timed=True):
    """A request whose stage 1 has STEPS steps of 2 lanes and stage 2 the
    fused ones of 3 lanes, each step a ``controlnet`` span (its device
    ms 10 x lanes where ``timed``) then a ``unet`` span; ``eager``: stage
    1's steps count ``graph.eager``; ``counted``: the ControlNet counts
    ``controlnet.cond_lanes``."""
    with profiling.request("omg.generate"):
        for phase, lanes, i0 in (("stage1", 2, 0), ("stage2", 3, FUSION + 1)):
            with profiling.span(phase):
                for _ in profiling.steps(i0, STEPS):
                    if eager and phase == "stage1":
                        profiling.count("graph.eager")
                    with profiling.span("controlnet") as c:
                        if counted:
                            profiling.count("controlnet.cond_lanes", lanes)
                        if timed:
                            c.device_ns = 10_000_000 * lanes
                    with profiling.span("unet"):
                        pass


def read(name, n_done=2):
    return run.load_metric(name).read(rec_of(n_done, STEPS))


def test_the_pose_metrics_on_fabricated_records(fresh_records):
    for _ in range(4):          # the warm-up, two in the window, the traced
        record()
    assert read("s1_controlnet_ms.pose") == 20.0
    assert read("s2_controlnet_ms.pose") == 30.0
    assert read("s1_eager_steps.pose") == 100.0
    n1, n2 = STEPS, STEPS - FUSION - 1
    assert read("cn_cond_lanes_per_step.pose") == (2 * n1 + 3 * n2) / (n1 + n2)
    assert run.load_metric("s1_eager_steps.pose").UNIT == "%"
    assert run.load_metric("cn_cond_lanes_per_step.pose").UNIT == "lanes"


def test_graphed_steps_read_zero_eager(fresh_records):
    """A program that counts graphs: a warm-up that captured, a window of
    steps that ran no eager forward."""
    with profiling.request("omg.generate"):
        with profiling.span("stage1"):
            for _ in profiling.steps(0, STEPS):
                profiling.count("graph.captures")
    for _ in range(3):
        record(eager=False)
    assert read("s1_eager_steps.pose") == 0.0


def test_a_program_without_the_counters_or_events_reads_nothing(
        fresh_records):
    for _ in range(4):
        record(eager=False, counted=False, timed=False)
    for name in POSE:
        assert read(name) is None, name


def test_a_program_without_records_reads_nothing(fresh_records,
                                                 monkeypatch):
    for _ in range(3):
        record()
    monkeypatch.delattr(profiling, "REQUESTS")
    for name in POSE:
        assert read(name, 1) is None, name
