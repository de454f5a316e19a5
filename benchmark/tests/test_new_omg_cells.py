"""The InstantID cell and the batched OMG cell at a tiny size on the CPU:
sound runs correct, the fp8 reference not, and runs with the program
broken underneath (the IdentityNet or the IP branch dropped, two requests'
LoRAs swapped) not correct; the new metrics read the program's span and
counter. ``test_reference_imports.py`` holds every file of
``reference/``, ``instantid.py`` too, to its imports."""

import functools
import importlib.util

import pytest
import torch

from benchmark import run
from benchmark.tests import planted, readings, tiny_cells
from benchmark.tests.test_discovery import fake_trace
from omg_tpu_torch.pipelines import omg


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny_cells.tree(tmp_path_factory.mktemp("bench"))


def line(root, cell, seed=5, **kw):
    return run.run_cell(cell, seed, 0.0, False, device=torch.device("cpu"),
                        root=root, **kw)


@pytest.mark.parametrize("cell", list(tiny_cells.CELLS))
def test_sound_runs_are_correct(root, cell):
    out = line(root, cell)
    assert out["correct"] is True
    assert set(out["checks"]) == set(tiny_cells.LIMITS[cell])


@pytest.mark.parametrize("cell", list(tiny_cells.CELLS))
def test_the_fp8_reference_is_not_correct(root, cell):
    (got,) = readings.readings(cell, [7], device=torch.device("cpu"),
                               root=root)
    assert got["correct"] is True
    assert got["fp8_reference_correct"] is False


@pytest.mark.parametrize("fault", sorted(planted.FAULTS))
def test_a_dropped_identity_part(root, fault):
    """The IdentityNet's residuals or the IP tokens never reach stage 2's
    concept lanes: the concept lanes' gap reads above its limit."""
    with planted.planted(planted.FAULTS[fault]()):
        out = line(root, "tiny_iid")
    assert out["correct"] is False
    assert out["checks"]["region_eps_gap"]["value"] > \
        out["checks"]["region_eps_gap"]["limit"]


def test_two_requests_loras_swapped(root):
    """The checked request of the batch and its neighbour trade LoRAs
    between the conditioning and stage 2."""
    entry = importlib.util.spec_from_file_location(
        "tiny_batch_entry", root / "entries" / "omg_batch.py")
    mod = importlib.util.module_from_spec(entry)
    entry.loader.exec_module(mod)
    ctx = type("C", (), {"seed": 5})
    place = mod.checked(ctx, {"index": 0})
    with planted.planted(planted.loras_swapped(place,
                                               (place + 1) % mod.BATCH)):
        assert line(root, "tiny_batch")["correct"] is False


def test_the_batch_runs_as_one_program(root, monkeypatch):
    """No request of the batch falls back to a serial ``generate``."""
    @functools.wraps(omg.OMG.generate)
    def serial(*a, **k):
        raise AssertionError("a batch request ran serially")

    monkeypatch.setattr(omg.OMG, "generate", serial)
    assert line(root, "tiny_batch")["correct"] is True


@pytest.fixture(scope="module")
def traced(root):
    mp = pytest.MonkeyPatch()
    fake_trace(mp)
    try:
        return run.run_cell("tiny_iid", 13, 1.0, True,
                            device=torch.device("cpu"), root=root)
    finally:
        mp.undo()


def test_the_instantid_metrics_on_a_tiny_cell(traced):
    m = {k: v["value"] for k, v in traced["metrics"].items()}
    # the tiny UNet's 4 attn2, each computing to_k_ip and to_v_ip, in the
    # one UNet forward of every stage-2 step
    assert m["s2_ip_kv_per_step.iid"] == 8.0
    # the IdentityNet's per-lane scale goes up in every stage-2 step
    assert m["s2_syncs_per_step.latency"] == 1.0 + 1.0 / 2
    # device ms come from CUDA events: none on the CPU
    assert "s2_identitynet_ms.iid" not in m
    assert traced["metrics"]["s2_ip_kv_per_step.iid"]["unit"] == "products"


def test_instantid_flops_match_hand_counts():
    """The IdentityNet, the IP branch and the resampler against hand
    counts on a tiny geometry (h x w = 4 x 6 latents)."""
    from benchmark import flops_instantid as fli
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

    cn = dict(tiny_unet(), conditioning_channels=3,
              conditioning_embedding_out_channels=[2, 4, 4, 8])
    want = lin(1, 8, temb) + 2 * lin(1, temb, temb) + lin(1, 20, temb)
    want += conv(2, 3, 3, px) + conv(2, 2, 3, px) + conv(4, 2, 3, px // 4)
    want += conv(4, 4, 3, px // 4) + conv(4, 4, 3, px // 16)
    want += conv(4, 4, 3, px // 16) + conv(8, 4, 3, hw) + conv(8, 8, 3, hw)
    want += conv(8, 4, 3, hw) + res(8, 8, hw) + conv(8, 8, 3, q)
    want += res(8, 16, q) + tr(16, q, 16) + 2 * res(16, 16, q) + \
        tr(16, q, 16)
    want += 2 * conv(8, 8, 1, hw) + conv(8, 8, 1, q) + conv(16, 16, 1, q)
    want += conv(16, 16, 1, q)
    assert fli.identitynet_forward(cn, 4, 6) == want
    # 4 attn2 (down 1, up 2, mid 1), all 16 wide at the q tokens
    assert fli.ip_branch(tiny_unet(), 4, 6) == 4 * (
        2 * lin(16, 12, 16) + 4 * q * 16 * 16)
    r = dict(dim=8, depth=1, dim_head=2, heads=2, num_queries=3,
             embedding_dim=5, output_dim=12, ff_mult=2)
    assert fli.resampler(r) == (
        lin(1, 5, 8) + lin(3, 8, 4) + lin(4, 8, 8) + 4 * 3 * 4 * 4
        + lin(3, 4, 8) + lin(3, 8, 16) + lin(3, 16, 8) + lin(3, 8, 12))
