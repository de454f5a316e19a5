"""The mesh latency mode's stage 1 and VAE decode on CPU ranks (``gloo``)
against the JAX package's spatial sharding on virtual devices and against
the unsharded runs: ``_denoise_cfg_range`` spatially split (CFG lanes over
data, latent H over model), its lane-only layout, with DeepCache, and the
H-split ``decode_latents``."""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from omg_tpu.diffusion import schedulers as jsched
from omg_tpu.models import unet as junet
from omg_tpu.models import vae as jvae
from omg_tpu.parallel import mesh as jmesh
from omg_tpu.pipelines import multiconcept as jmc
from omg_tpu.pipelines import sdxl as jsdxl
from omg_tpu_torch.diffusion import schedulers
from omg_tpu_torch.parallel import launch
from omg_tpu_torch.pipelines import multiconcept as mc
from omg_tpu_torch.pipelines import omg, sdxl

import torch_mesh_workers as workers
from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse)
from torch_port_helpers import np_tree

ATOL = 2e-4             # tests/test_parallel.py:129-165
DECODE_ATOL = 2e-5      # tests/test_parallel.py:168-183
STEPS = 2


@pytest.fixture(scope="module")
def reference():
    """tests/test_parallel.py:129-165's inputs, at the 64 (divisible) and
    48 (lane-only) canvases, with the JAX results."""
    cfg = jsdxl.tiny_config()
    params = junet.init_params(jax.random.PRNGKey(0), cfg.unet)
    sched = jsched.make_schedule("euler", STEPS)
    d, pdim = cfg.unet.cross_attention_dim, cfg.text_encoder_2.projection_dim
    ks = jax.random.split(jax.random.PRNGKey(1), 4)
    enc = [np.asarray(jax.random.normal(ks[0], (1, 77, d))),
           np.asarray(jax.random.normal(ks[1], (1, 77, d))),
           np.asarray(jax.random.normal(ks[2], (1, pdim))),
           np.asarray(jax.random.normal(ks[3], (1, pdim)))]
    out = {"unet": np_tree(params), "base": enc, "runs": {}}
    for key, hw, data, model, seq, steps, dc in (
            ("s22", 64, 2, 2, True, STEPS, 0),
            ("s12", 64, 1, 2, True, STEPS, 0),
            ("lanes22", 48, 2, 2, False, STEPS, 0),
            # DeepCache (tests/test_parallel.py:232-273): 3 steps at
            # interval 2, full(0), shallow(1), full(2)
            ("s22dc", 64, 2, 2, True, 3, 2)):
        sched = jsched.make_schedule("euler", steps)
        base = jmc.make_base_inputs(enc[0], enc[2], enc[1], enc[3],
                                    jsdxl.add_time_ids((hw, hw), (0, 0),
                                                       (hw, hw)), 7.5)
        lat0 = jsdxl.prepare_latents(jax.random.PRNGKey(3), 1, hw, hw, sched,
                                     cfg.unet.dtype)
        st0 = jsched.init_state(sched, lat0.shape)
        mesh = jmesh.make_mesh(data * model, data=data, model=model)
        spatial = NamedSharding(mesh, P(jmesh.DATA_AXIS,
                                        jmesh.MODEL_AXIS if seq else None))
        got, _ = jmc._denoise_cfg_range(cfg, sched, params, lat0, st0, base,
                                        i0=0, i1=steps,
                                        spatial_sharding=spatial,
                                        cache_interval=dc)
        ref, _ = jmc._denoise_cfg_range(cfg, sched, params, lat0, st0, base,
                                        i0=0, i1=steps, cache_interval=dc)
        out["runs"][key] = dict(hw=hw, data=data, seq=seq, steps=steps,
                                cache_interval=dc, lat0=np.asarray(lat0),
                                jax_spatial=np.asarray(got),
                                jax_plain=np.asarray(ref))
    vae_params = jvae.init_params(jax.random.PRNGKey(1), cfg.vae)
    lat = np.asarray(jax.random.normal(jax.random.PRNGKey(2), (2, 8, 8, 4)))
    out["vae"], out["latents"] = np_tree(vae_params), lat
    out["decode"] = {}
    for n in (2, 4):
        sh = NamedSharding(jmesh.make_mesh(n, data=n, model=1),
                           P(None, jmesh.DATA_AXIS))
        out["decode"][n] = np.asarray(jsdxl.decode_latents(
            cfg, vae_params, jax.numpy.asarray(lat), spatial_sharding=sh))
    return out


def _case(ref, keys):
    runs = {k: dict(unet=ref["unet"], base=ref["base"],
                    **{f: ref["runs"][k][f]
                       for f in ("hw", "data", "seq", "lat0", "steps",
                                 "cache_interval")})
            for k in keys}
    return {"stage1": runs,
            "decode": {"vae": ref["vae"], "latents": ref["latents"]}}


@pytest.fixture(scope="module")
def ranks(reference):
    """One spawn per world size: 4 ranks run the (2, 2) grid (spatial and
    lane-only), 2 ranks the (1, 2) grid; both decode H-split."""
    return {
        4: launch.spawn(workers.pipeline_rank, 4, backend="gloo",
                        devices=["cpu"] * 4, args=(_case(reference, ["s22", "lanes22", "s22dc"]),),
                        timeout=150),
        2: launch.spawn(workers.pipeline_rank, 2, backend="gloo",
                        devices=["cpu"] * 2, args=(_case(reference, ["s12"]),), timeout=150)}


@pytest.mark.parametrize("key,n", [("s22", 4), ("s12", 2), ("lanes22", 4),
                                   ("s22dc", 4)])
def test_spatial_stage1_matches_jax_and_unsharded(reference, ranks, key, n):
    """Every rank ends with the whole latents, equal to JAX's spatially
    sharded range and to the unsharded one; the split layouts ran their
    self-attention sequence-sharded, the lane-only layout did not. With
    DeepCache the shallow step runs split too, from each rank's rows of
    the cache."""
    run = reference["runs"][key]
    cfg = sdxl.tiny_config()
    model = workers.tiny_unet(reference["unet"])
    with torch.no_grad():
        mine, _ = mc._denoise_cfg_range(
            cfg, schedulers.make_schedule("euler", run["steps"]), model,
            workers.t(run["lat0"]), schedulers.init_state(),
            workers.base_inputs(reference["base"], (run["hw"],) * 2),
            i0=0, i1=run["steps"], cache_interval=run["cache_interval"])
    np.testing.assert_allclose(mine.numpy(), run["jax_plain"], atol=ATOL)
    for r, res in enumerate(ranks[n]):
        got = res[key]["latents"]
        np.testing.assert_allclose(got, run["jax_spatial"], atol=ATOL,
                                   err_msg=f"rank {r} vs JAX spatial")
        np.testing.assert_allclose(got, mine.numpy(), atol=ATOL,
                                   err_msg=f"rank {r} vs unsharded")
        assert (res[key]["seq_calls"] > 0) is run["seq"]


@pytest.mark.parametrize("height,n,want", [
    (64, 2, True), (64, 4, True), (48, 2, False), (32, 4, False),
    (1024, 4, True), (1216, 4, False), (832, 2, True)])
def test_seq_split_rule(height, n, want):
    """``omg.py:406-413``: H splits only while the deepest level divides."""
    cfg = sdxl.tiny_config() if height < 128 else sdxl.sdxl_config()
    assert omg.seq_splits(cfg, height, n) is want


@pytest.mark.parametrize("n", [2, 4])
def test_spatial_decode_matches_jax(reference, ranks, n):
    """``decode_latents(spatial=...)`` H-split over n ranks: every rank
    returns the whole image, equal to JAX's spatially sharded decode."""
    for r, res in enumerate(ranks[n]):
        np.testing.assert_allclose(res["decode"], reference["decode"][n],
                                   atol=DECODE_ATOL, err_msg=f"rank {r}")
