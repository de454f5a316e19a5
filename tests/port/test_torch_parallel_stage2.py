"""The reference-layout 4+2K stage-2 program, unsharded and with its lanes
split over CPU ranks (``gloo``), against the JAX package's unsharded
result on ``tests/test_parallel.py``'s inputs; and ``fuse_region_noise``.

Splits: 8 lanes over 2 ranks (4/4) and over 3 ranks (3/3/2, so lane 2
and lane 3 sit on different ranks and the P2P rows move between them;
once with the self-replace window over all of stage 2 and masks that
leave half the latent to lane 3), K = 1 over 4 ranks (6 lanes, 2/2/1/1),
and DeepCache's per-lane cache split with the lanes over 2 ranks."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omg_tpu.control import p2p as jp2p
from omg_tpu.control import regions as jregions
from omg_tpu.diffusion import schedulers as jsched
from omg_tpu.models import unet as junet
from omg_tpu.pipelines import multiconcept as jmc
from omg_tpu.pipelines import sdxl as jsdxl
from omg_tpu_torch.control import regions
from omg_tpu_torch.diffusion import schedulers
from omg_tpu_torch.parallel import comm, launch
from omg_tpu_torch.pipelines import multiconcept as mc
from omg_tpu_torch.pipelines import sdxl

import torch_mesh_workers as workers
from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse)
from torch_port_helpers import normal, np_tree, t

ATOL = 2e-5             # tests/test_parallel.py:35-79


def _case(n_concepts, steps, stage1_key, self_replace=0.4, quadrants=False,
          cache_interval=0):
    """tests/test_parallel.py's stage-2 inputs (K = 2: :35-79, K = 1:
    :186-230), the JAX stage-1 cache, and the JAX 4-row result on it.

    There the concepts share the base prompt and the masks cover the whole
    latent, so copy B never parts from copy A and the P2P edits of lane 3
    are no-ops. ``quadrants`` gives the concepts prompts of their own and
    masks two quadrants, so copy B parts from copy A after the first
    fused step and lane 3's edits reach the output outside the masks.
    ``cache_interval``: DeepCache in both stages (tests/test_parallel.py:
    276-318)."""
    H = W = 32
    cfg = jsdxl.tiny_config()
    params = junet.init_params(jax.random.PRNGKey(0), cfg.unet)
    sched = jsched.make_schedule("euler", steps)
    d, pdim = cfg.unet.cross_attention_dim, cfg.text_encoder_2.projection_dim
    ks = jax.random.split(jax.random.PRNGKey(1), 4)
    ep, en = (jax.random.normal(k, (1, 77, d)) for k in ks[:2])
    pp, pn = (jax.random.normal(k, (1, pdim)) for k in ks[2:])
    tids = jsdxl.add_time_ids((H, W), (0, 0), (H, W))
    base = jmc.make_base_inputs(ep, pp, en, pn, tids, 7.5)
    cp, cpp = ep, pp
    if quadrants:
        kc = jax.random.split(jax.random.PRNGKey(2), 2)
        cp, cpp = (jax.random.normal(kc[0], (1, 77, d)),
                   jax.random.normal(kc[1], (1, pdim)))
    concept = jmc.make_concept_inputs(cp, cpp, en, pn, tids)
    ctl = jp2p.P2PControl.build(["a", "a"], steps,
                                self_replace_steps=self_replace,
                                width=2, height=2)
    m = np.zeros((n_concepts, 4, 4), np.float32)
    rows = slice(0, 2) if quadrants else slice(None)
    m[0, rows, :2] = 1.0
    if n_concepts > 1:
        m[1, rows if not quadrants else slice(2, 4), 2:] = 1.0
    _, cache = jmc.sample_stage1_cached(
        cfg, sched, params, key=jax.random.PRNGKey(stage1_key), height=H,
        width=W, base_inputs=base, fusion_start=1,
        cache_interval=cache_interval)
    cache4 = jmc.StageCache(latents=cache.latents,
                            sched_state=cache.sched_state, a_traj=None,
                            a_final=cache.a_final)
    want = jmc.sample_stage2_resumed(
        cfg, sched, params, cache4, base_inputs=base, controller=ctl,
        concept_inputs=[concept] * n_concepts,
        concept_loras=[None] * n_concepts, masks=jnp.asarray(m),
        fusion_start=1, cache_interval=cache_interval)
    return {"hw": H, "steps": steps, "fusion_start": 1,
            "cache_interval": cache_interval,
            "n_concepts": n_concepts, "self_replace": self_replace,
            "unet": np_tree(params),
            "base": [np.asarray(a) for a in (ep, en, pp, pn)],
            "concept": [np.asarray(a) for a in (cp, en, cpp, pn)],
            "masks": m, "cache_latents": np.asarray(cache.latents),
            "cache_final": np.asarray(cache.a_final),
            "want": np.asarray(want)}


@pytest.fixture(scope="module")
def cases():
    # k2_dc: 5 steps, boundary 2, interval 2: steps 2 (full), 3 (shallow)
    # and 4 (full)
    return {"k2": _case(2, 4, 5), "k2_self": _case(2, 4, 5, 1.0, quadrants=True),
            "k1": _case(1, 3, 3),
            "k2_dc": _case(2, 5, 5, quadrants=True, cache_interval=2)}


@pytest.fixture(scope="module")
def ranks(cases):
    def spawn(n, keys):
        case = {"stage2": {k: {f: v for f, v in cases[k].items()
                               if f != "want"} for k in keys}}
        return launch.spawn(workers.pipeline_rank, n, backend="gloo",
                            devices=["cpu"] * n, args=(case,), timeout=150)
    return {2: spawn(2, ["k2", "k2_dc"]), 3: spawn(3, ["k2", "k2_self"]),
            4: spawn(4, ["k1"])}


@pytest.mark.parametrize("key", ["k2", "k2_self", "k1", "k2_dc"])
def test_four_row_program_matches_jax(cases, key):
    """The 4+2K program on one device (no trajectory in the cache)."""
    got = workers.stage2_resumed(cases[key])
    np.testing.assert_allclose(got, cases[key]["want"], atol=ATOL)


@pytest.mark.parametrize("n,key", [(2, "k2"), (3, "k2"), (3, "k2_self"),
                                   (4, "k1"), (2, "k2_dc")])
def test_lane_sharded_program_matches_jax(cases, ranks, n, key):
    """Every rank carries the same latents, equal to the JAX unsharded
    4-row result."""
    for r, res in enumerate(ranks[n]):
        np.testing.assert_allclose(res[key], cases[key]["want"], atol=ATOL,
                                   err_msg=f"rank {r} of {n}")


def test_lane_sharding_needs_a_concept(cases):
    case = dict(cases["k1"], n_concepts=0, masks=np.zeros((0, 4, 4),
                                                          np.float32))
    with pytest.raises(ValueError, match="at least one concept"):
        workers.stage2_resumed(case, comm.Group((0, 1), 0))


def test_zero_concepts_runs_the_plain_four_rows(cases):
    """K = 0 on the 4+2K program is JAX's zero-concept stage 2 (P2P, no
    fusion), on one device."""
    case = dict(cases["k1"], n_concepts=0,
                masks=np.zeros((0, 4, 4), np.float32))
    cfg = jsdxl.tiny_config()
    sched = jsched.make_schedule("euler", case["steps"])
    params = jax.tree.map(jnp.asarray, case["unet"])
    ep, en, pp, pn = (jnp.asarray(a) for a in case["base"])
    tids = jsdxl.add_time_ids((32, 32), (0, 0), (32, 32))
    cache = jmc.StageCache(
        latents=jnp.asarray(case["cache_latents"]),
        sched_state=jsched.init_state(sched, (1, 4, 4, 4)), a_traj=None,
        a_final=jnp.asarray(case["cache_final"]))
    want = jmc.sample_stage2_resumed(
        cfg, sched, params, cache,
        base_inputs=jmc.make_base_inputs(ep, pp, en, pn, tids, 7.5),
        controller=jp2p.P2PControl.build(["a", "a"], case["steps"],
                                         self_replace_steps=0.4, width=2,
                                         height=2),
        concept_inputs=[], concept_loras=[], masks=jnp.zeros((0, 4, 4)),
        fusion_start=1)
    np.testing.assert_allclose(workers.stage2_resumed(case),
                               np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("active", [True, False])
def test_fuse_region_noise_matches_jax(active):
    rng = np.random.default_rng(5)
    eps, preds = normal(rng, 4, 6, 6, 4), normal(rng, 2, 2, 6, 6, 4)
    masks = (rng.random((2, 6, 6)) > 0.5).astype(np.float32)
    want = jregions.fuse_region_noise(jnp.asarray(eps), jnp.asarray(preds),
                                      jnp.asarray(masks),
                                      active=jnp.asarray(active))
    got = regions.fuse_region_noise(t(eps), t(preds), t(masks),
                                    active=active)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


def test_stage2_resumed_takes_the_trajectory_program_when_it_can(cases):
    """A cache with copy A's trajectory and no lane sharding still runs the
    3+2K program (it does not read lanes 0-3 of the 4-row layout)."""
    calls = []
    real = mc._denoise_mc_range_traj

    def spy(*args, **kwargs):
        calls.append(1)
        return real(*args, **kwargs)

    case = cases["k1"]
    mc._denoise_mc_range_traj = spy
    try:
        traj = torch.zeros((2, 1, 4, 4, 4))
        cache = mc.StageCache(t(case["cache_latents"]),
                              schedulers.SchedulerState(2), a_traj=traj,
                              a_final=t(case["cache_final"]))
        with torch.no_grad():
            mc.sample_stage2_resumed(
                sdxl.tiny_config(),
                schedulers.make_schedule("euler", case["steps"]),
                workers.tiny_unet(case["unet"]), cache,
                base_inputs=workers.base_inputs(case["base"], (32, 32)),
                controller=None,
                concept_inputs=[workers.concept_inputs(case["concept"],
                                                       (32, 32))],
                concept_loras=[None], masks=t(case["masks"]),
                fusion_start=1)
    finally:
        mc._denoise_mc_range_traj = real
    assert calls == [1]
