"""The port's OMG with a spatial ControlNet against the plain fp32
reference the benchmark holds it to (``benchmark/reference/pose.py``), at
a tiny size on the CPU: seeded random weights in checkpoint layout
(every zero conv non-zero) loaded through ``convert.convert_controlnet``,
the pose images the benchmark's mix draws, everything fp32.

Both sides compute the same fp32 products in another order, so each
comparison allows 1e-4 relative, as ``test_torch_instantid_reference.py``
argues; the gaps read 1e-6 to 1e-5. The counters the pose cell reads
(``controlnet.cond_lanes``, ``graph.eager``) are held to what runs.

This file imports no jax.
"""

import json
import pathlib

import numpy as np
import pytest
import torch

from benchmark import generator as gen
from benchmark import run, trace
from benchmark import weights_instantid as wi
from benchmark.entries import omg_pose as entry
from benchmark.reference import pipelines as ref_pipelines
from benchmark.reference import pose as ref_pose
from benchmark.tests import planted, planted_pose, tiny_pose
from omg_tpu_torch.models import openpose
from omg_tpu_torch.utils import profiling

BENCH = pathlib.Path(__file__).resolve().parents[2] / "benchmark"
SEED = 13
RTOL = 1e-4         # see the module docstring


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Torch on one intra-op thread for the module, as every port test
    module runs (the workers share the host's cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def two_width(u: dict) -> None:
    """Attention at both levels of the tiny geometry: widths 32 and 64."""
    u.update(down_block_types=["CrossAttnDownBlock2D"] * 2,
             up_block_types=["CrossAttnUpBlock2D"] * 2)


@pytest.fixture(scope="module")
def cfg():
    base = json.loads((BENCH / "configs" / "omg_lora2_pose_sdxl.json")
                      .read_text())
    c = tiny_pose.tiny_config(base)
    two_width(c["unet"])
    two_width(c["controlnet"])
    return c


@pytest.fixture(scope="module")
def mix():
    return json.loads((BENCH / "traffic" / "omg_pose_closed_loop.json")
                      .read_text())


@pytest.fixture(scope="module")
def cn_sd(cfg):
    return {k: v.float() for k, v in
            entry.controlnet_state_dict(cfg, SEED, "cpu").items()}


def close(got: torch.Tensor, want: torch.Tensor) -> None:
    assert got.shape == want.shape
    gap = (got - want).abs().max() / want.abs().max()
    assert gap < RTOL, float(gap)


def test_controlnet_residuals_over_the_text_context(cfg, mix, cn_sd):
    """Every skip's residual and the mid's, on a drawn pose image with the
    77-token text context, through ``convert.convert_controlnet``."""
    from omg_tpu_torch import convert
    cn = convert.convert_controlnet(
        entry.controlnet_state_dict(cfg, SEED, "cpu"),
        entry.controlnet_config(cfg), device="cpu")
    g = torch.Generator().manual_seed(3)
    u, p = cfg["unet"], cfg["pipeline"]
    h = p["height"] // 8
    x = torch.randn((3, 4, h, h), generator=g)
    ctx = torch.randn((3, 77, u["cross_attention_dim"]), generator=g)
    pooled = torch.randn((3, u["projection_class_embeddings_input_dim"]
                          - 6 * u["addition_time_embed_dim"]), generator=g)
    req = gen.requests(mix, SEED)[0]
    pose = ref_pose.pose_tensor(entry.pose_image(mix, req, 8 * h, 8 * h),
                                "cpu")
    i = 2
    want = ref_pose.residuals(cn_sd, cfg, x, i, ctx, pooled, pose)
    t = ref_pose.Euler(cfg["scheduler"], p["num_steps"]).timesteps[i]
    tids = ref_pose.time_ids(p["height"], p["width"], 3, "cpu")
    with torch.no_grad():
        down, mid = cn(x.permute(0, 2, 3, 1), int(t), ctx,
                       pose.permute(0, 2, 3, 1).expand(3, -1, -1, -1),
                       text_embeds=pooled, time_ids=tids,
                       conditioning_scale=p["controlnet_scale"])
    assert len(down) == len(want[0]) == len(wi.skip_channels(
        cfg["controlnet"]))
    for got, w in zip(down, want[0]):
        close(got, w)
    close(mid, want[1])


@pytest.fixture(scope="module")
def generated(cfg, mix):
    """One request of ``OMG.generate(spatial_condition=...,
    controlnet_params=..., masks=...)`` through the benchmark's entry, its
    scheduler steps and ControlNet residuals kept."""
    cell = {"limits": {}, "sample": 1}
    ctx = run.Ctx(cfg, cell, mix, SEED, torch.device("cpu"), None,
                  trace.Spans(), gen.requests(mix, SEED))
    with torch.inference_mode():
        state = entry.setup(ctx)
        req = ctx.requests[1]
        out = entry.run(ctx, state, req)
        record = profiling.REQUESTS[-1]
        entry.free(state)
    return ctx, req, out, record


def test_generate_against_the_reference(generated):
    """Stage 1's first and last steps, stage 2's first and last (fused:
    after the fusion start), each from the program's own latents, and
    the residuals of both stages' first ControlNet forwards, and the
    conditioning embedder's input and output (``entry.check``'s relative
    mean gaps)."""
    ctx, req, out, _ = generated
    gaps = entry.check(ctx, req, out)
    assert set(gaps) == {"eps_gap", "step_gap", "cn_residual_gap",
                         "cn_cond_gap", "decode_gap_levels"}
    for k in ("eps_gap", "step_gap", "cn_residual_gap", "cn_cond_gap"):
        assert gaps[k] < RTOL, (k, gaps[k])
    assert gaps["decode_gap_levels"] <= 0.5     # a truncation flip


@pytest.mark.parametrize("fault", ["controlnet_dropped_stage1",
                                   "controlnet_dropped_stage2"])
def test_a_dropped_controlnet_moves_the_gap(cfg, mix, fault):
    """Stage 1 or stage 2 run without the ControlNet: the guided
    prediction moves far past the tolerance, and the stage's residuals are
    missing."""
    cell = {"limits": {}, "sample": 1}
    ctx = run.Ctx(cfg, cell, mix, SEED, torch.device("cpu"), None,
                  trace.Spans(), gen.requests(mix, SEED))
    with torch.inference_mode():
        state = entry.setup(ctx)
        req = ctx.requests[1]
        with planted.planted(planted_pose.FAULTS[fault]()):
            out = entry.run(ctx, state, req)
        entry.free(state)
    gaps = entry.check(ctx, req, out)
    assert gaps["eps_gap"] > 100 * RTOL
    assert gaps["cn_residual_gap"] == float("inf")


def test_cond_lanes_a_step(generated):
    """``controlnet.cond_lanes``: 2 lanes a stage-1 step, the 3 base lanes
    a stage-2 step, each in the step's one ``controlnet`` span."""
    ctx, _, _, r = generated
    p = ctx.cfg["pipeline"]
    (stage1,) = r.children(r.root, "stage1")
    (stage2,) = r.children(r.root, "stage2")
    s1, s2 = r.children(stage1, "step"), r.children(stage2, "step")
    assert len(s1) == p["num_steps"]
    assert len(s2) == p["num_steps"] - p["fusion_start"] - 1
    assert [r.total(s, "controlnet.cond_lanes") for s in s1] == [2] * len(s1)
    assert [r.total(s, "controlnet.cond_lanes") for s in s2] == [3] * len(s2)
    assert all([c.name for c in r.children(s)] == ["controlnet", "unet"]
               for s in s1 + s2)
    # off a card nothing runs eagerly for want of a graph
    assert r.total(r.root, "graph.eager") == 0


@pytest.mark.parametrize("fault", ["blank_condition", "shifted_condition",
                                   "swapped_channels", "signed_condition"])
def test_a_wrong_condition_image_moves_the_cond_gap(cfg, mix, fault):
    """The ControlNet handed a blank image, the pose moved 8 rows, its
    channels reversed, or in [-1, 1]: the condition path's gap moves far
    past the tolerance."""
    cell = {"limits": {}, "sample": 1}
    ctx = run.Ctx(cfg, cell, mix, SEED, torch.device("cpu"), None,
                  trace.Spans(), gen.requests(mix, SEED))
    with torch.inference_mode():
        state = entry.setup(ctx)
        req = ctx.requests[1]
        with planted.planted(planted_pose.FAULTS[fault]()):
            out = entry.run(ctx, state, req)
        entry.free(state)
    assert entry.check(ctx, req, out)["cn_cond_gap"] > 1e3 * RTOL


def test_the_host_tap_keeps_each_keys_first_call():
    """A tap keeps copies of the first call of each key in a request,
    which later calls and a later request do not change, and hands them
    over once."""
    mod = torch.nn.Identity()
    tap = entry.HostTap(mod, lambda args, out: (out.shape[0], [out]))
    a, b, c = torch.ones(2, 3), torch.full((2, 3), 2.0), torch.zeros(3, 3)
    for t in (a, b, c):
        mod(t)
    got = tap.take()
    assert sorted(got) == [2, 3]
    assert torch.equal(got[2][0], a) and torch.equal(got[3][0], c)
    assert tap.take() == {}
    mod(b)
    assert torch.equal(tap.take()[2][0], b) and torch.equal(got[2][0], a)
    tap.close()
    mod(c)
    assert tap.take() == {}


@pytest.mark.cuda
def test_every_stage1_step_counts_eager_on_the_card(cfg, mix):
    """On a card, with nothing forced: a request with the base ControlNet
    counts ``graph.eager`` once in each stage-1 step, and its residuals
    and steps still agree with the reference (TF32 off on both sides)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: graph.eager counts a card's "
                    "eager steps")
    dev = torch.device("cuda", 0)
    ctx = run.Ctx(cfg, {"limits": {}, "sample": 1}, mix, SEED, dev, None,
                  trace.Spans(), gen.requests(mix, SEED))
    with torch.inference_mode(), ref_pipelines.fp32_math():
        state = entry.setup(ctx)
        req = ctx.requests[2]
        out = entry.run(ctx, state, req)
        r = profiling.REQUESTS[-1]
        entry.free(state)
        gaps = entry.check(ctx, req, out)
    (stage1,) = r.children(r.root, "stage1")
    assert [r.total(s, "graph.eager") for s in r.children(stage1, "step")] \
        == [1] * cfg["pipeline"]["num_steps"]
    assert r.total(stage1, "graph.replays") == 0
    (stage2,) = r.children(r.root, "stage2")
    assert r.total(stage2, "graph.eager") == 0
    assert gaps["cn_residual_gap"] < 1e-3 and gaps["eps_gap"] < 1e-3, gaps
    assert gaps["cn_cond_gap"] < 1e-3, gaps


def test_pose_images_follow_the_seed(mix):
    """A seed's requests draw the same images again; another seed's
    differ; each image holds two skeletons, one inside each box."""
    size = 256
    a = [entry.pose_image(mix, r, size, size)
         for r in gen.requests(mix, 5)[:3]]
    b = [entry.pose_image(mix, r, size, size)
         for r in gen.requests(mix, 5)[:3]]
    c = [entry.pose_image(mix, r, size, size)
         for r in gen.requests(mix, 6)[:3]]
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert not any(np.array_equal(x, y) for x, y in zip(a, c))
    assert not np.array_equal(a[0], a[1])
    drawn = a[0].any(-1)
    boxes = gen.box_masks(mix, size, size).astype(bool)
    for box in boxes:
        assert (drawn & box).any()
    assert not (drawn & ~boxes.any(0)).any()


def test_drawn_by_boxes_equals_the_whole_canvas(mix):
    """Each person drawn by ``draw_bodypose`` in the box around its
    keypoints equals both drawn together on the whole canvas."""
    size = 256
    req = gen.requests(mix, 8)[4]
    pts = entry.keypoints(mix, req, size, size)
    cand = np.concatenate([np.concatenate(
        [q, np.ones((18, 1)), (np.arange(18) + 18 * k)[:, None]], 1)
        for k, q in enumerate(pts)])
    subset = np.array([list(range(18 * k, 18 * k + 18)) + [18, 18]
                       for k in range(len(pts))], np.float64)
    whole = openpose.draw_bodypose(np.zeros((size, size, 3), np.uint8),
                                   cand, subset)
    assert np.array_equal(entry.pose_image(mix, req, size, size), whole)
    assert np.array_equal(
        entry.pose_images(mix, [req], size, size)[req["index"]], whole)


def test_t2i_single_runs_two_lanes_a_step(tmp_path):
    """The single-image t2i cell's entry: 2 lanes in each of its steps'
    UNet forwards, counted and run."""
    cell, cfg, mix, t2i = run.load_cell("t2i_lora1_latency_1024")
    assert mix["images_per_request"] == 1
    assert t2i.unet_lanes(cfg) == [2] * cfg["pipeline"]["num_steps"]
    root = tiny_pose.tree(tmp_path)
    _, tiny_cfg, tiny_mix, tiny_entry = run.load_cell("tiny_t2i1", root)
    ctx = run.Ctx(tiny_cfg, {"limits": {}, "sample": 1}, tiny_mix, SEED,
                  torch.device("cpu"), None, trace.Spans(),
                  gen.requests(tiny_mix, SEED))
    with torch.inference_mode():
        state = tiny_entry.setup(ctx)
        with ctx.spans.request():
            tiny_entry.run(ctx, state, ctx.requests[1])
        tiny_entry.free(state)
    assert ctx.spans.lanes == tiny_entry.unet_lanes(tiny_cfg)
