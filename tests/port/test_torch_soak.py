"""Mixed concurrent load through the port's ``OMGServer`` (the port's
counterpart of tests/test_soak.py), at the tiny config on the CPU.

Nine jobs in seven classes (Euler at three seeds, LCM, DeepCache 2 and 2
"front", a 32x64 bucket, a gate miss and InstantID) are served one by
one (the serial baselines), then all at once over HTTP, where the drain
batches compatible ones. Checks:
  * no state bleed: every concurrent response equals its own serial
    baseline within 1 uint8 level (the batched-vs-single window that the
    ``generate_batch`` tests pin); a seed, mask or face mix-up would show
    as a large difference;
  * distinct seeds give distinct images;
  * the stage-2 status of each class (the gate miss runs stage 1 only);
  * the queue drains, the drain batched some of the storm, and
    ``/metrics`` rises by 2 ``stage2_skipped`` and 18 ``images_generated``
    (two passes of nine jobs);
  * each serial baseline equals JAX's ``OMG.generate`` of the same job
    (JAX's server turns the job into its arguments) within 1/255, with
    the weights carried over by ``from_jax``, both engines on the port's
    ``ToyTokenizer`` (JAX's own hashes words with the salted ``hash``,
    ROADMAP §3), the port's seeded draws replaced by JAX's ``PRNGKey``
    draws (initial latents and LCM's re-noise)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omg_tpu import config as jconfig
from omg_tpu.pipelines import omg as jomg
from omg_tpu.pipelines import sdxl as jsdxl
from omg_tpu.serving.registry import Registry as JRegistry
from omg_tpu.serving.server import OMGServer as JOMGServer
from omg_tpu_torch import config
from omg_tpu_torch.diffusion import schedulers
from omg_tpu_torch.pipelines import omg, sdxl
from omg_tpu_torch.serving.registry import Registry
from omg_tpu_torch.serving.server import OMGServer
from omg_tpu_torch.text.tokenizer import ToyTokenizer
from omg_tpu_torch.tools import serve_bench

from test_torch_conditioned_pipeline import _instantid_pair
from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse)
from torch_port_helpers import left_right_masks, t, tiny_sdxl

H = W = 32


def _jobs():
    """(class, job, stage 2 expected): tests/test_soak.py's mix."""
    rw = "[the man]-*-[ugly]|[the woman]-*-[ugly]"
    gate = "the man and the woman here"
    kps = [[8, 8], [24, 8], [16, 14], [10, 22], [22, 22]]
    base = {"prompt": gate, "prompt_rewrite": rw, "height": H, "width": W}
    out = [("euler", dict(base, seed=seed), True) for seed in (11, 12, 13)]
    out += [
        ("lcm", dict(base, seed=21, scheduler="lcm"), True),
        ("dc2", dict(base, seed=31, cache_interval=2), True),
        ("dc2front", dict(base, seed=32, cache_interval=2,
                          cache_schedule="front"), True),
        ("bucket", dict(base, seed=41, width=2 * W), True),
        ("gate_miss", dict(base, prompt="two people at the beach", seed=51),
         False),
        ("instantid", dict(base, seed=61, face_kps=[kps, kps],
                           face_embeddings=[
                               list(np.random.RandomState(s).randn(16))
                               for s in (6, 7)]), True)]
    return out


def _jax_draws(mp):
    """The port's seeded draws replaced by JAX's: the initial latents of
    ``PRNGKey(seed)`` and LCM's ``fold_in(fold_in(PRNGKey(seed), 777),
    i)`` re-noise."""
    def prepare(generator, batch, height, width, sched, dtype=torch.float32,
                device=None):
        noise = jax.random.normal(jax.random.PRNGKey(generator.initial_seed()),
                                  (batch, height // 8, width // 8, 4))
        return schedulers.scale_initial_noise(sched, t(noise)).to(
            device=device, dtype=dtype)

    def step_noise(seed, i, shape, device):
        key = jax.random.fold_in(jax.random.PRNGKey(seed), 777)
        return t(jax.random.normal(jax.random.fold_in(key, i), shape,
                                   jnp.float32)).to(device)

    mp.setattr(sdxl, "prepare_latents", prepare)
    mp.setattr(schedulers, "step_noise", step_noise)


@pytest.fixture(scope="module")
def soak():
    jp, tp = tiny_sdxl(seed=70)
    jid, tid, _, _ = _instantid_pair(None)
    tok = ToyTokenizer()
    kw = dict(tokenizer=tok, tokenizer_2=tok, mask_provider=left_right_masks,
              num_steps=2)
    jeng = jomg.OMG(cfg=jsdxl.tiny_config(), params=jp,
                    cn_cfg=jconfig.tiny_controlnet(), **kw)
    jsrv = JOMGServer(jeng, JRegistry(), instantid=jid, max_batch=2)
    client = serve_bench.Client(OMGServer(
        omg.OMG(cfg=sdxl.tiny_config(), params=tp,
                cn_cfg=config.tiny_controlnet(), **kw), Registry(),
        instantid=tid, max_batch=2, max_queue=32))
    jobs = _jobs()
    with pytest.MonkeyPatch.context() as mp:
        _jax_draws(mp)
        try:
            before = client.counters()
            serial = [client.post(dict(job)) for _, job, _ in jobs]
            storm = serve_bench.concurrent(
                lambda i: client.post(dict(jobs[i][1])), len(jobs))
            health = client.get("/healthz")
            after = client.counters()
        finally:
            client.close()
    want = []
    for _, job, _ in jobs:
        req = jsrv._job_to_request(dict(job))
        want.append(jeng.generate(req.pop("prompt"), **req))
    return dict(jobs=jobs, serial=serial, storm=storm, want=want,
                health=health, delta={k: after.get(k, 0) - before.get(k, 0)
                                      for k in after})


def _ids(jobs):
    return [f"{i}-{cls}" for i, (cls, _, _) in enumerate(jobs)]


def test_stage2_status_per_class(soak):
    for (cls, _, s2), a, b in zip(soak["jobs"], soak["serial"],
                                  soak["storm"]):
        assert a["stage2_ran"] is s2 and b["stage2_ran"] is s2, cls
        assert a["masks_found"] == ([True, True] if s2 else [False, False])


def test_storm_equals_serial_baselines(soak):
    """No state bleed across concurrent requests: each storm response is
    its own serial baseline within one uint8 level."""
    for (cls, job, _), a, b in zip(soak["jobs"], soak["serial"],
                                   soak["storm"]):
        x, y = serve_bench.decode(a["image"]), serve_bench.decode(b["image"])
        assert x.shape == (job["height"], job["width"], 3), cls
        assert np.abs(x.astype(int) - y.astype(int)).max() <= 1, cls


def test_distinct_seeds_give_distinct_images(soak):
    euler = [serve_bench.decode(out["image"]) for (cls, _, _), out in
             zip(soak["jobs"], soak["serial"]) if cls == "euler"]
    assert len(euler) == 3
    for i in range(3):
        for j in range(i + 1, 3):
            assert not np.array_equal(euler[i], euler[j]), (i, j)


def test_queue_drains_and_metrics_count(soak):
    assert soak["health"]["ok"] is True and soak["health"]["queued"] == 0
    # the gate miss ran twice (its baseline and the storm), nothing else
    # skipped stage 2
    assert soak["delta"]["stage2_skipped"] == 2
    assert soak["delta"]["images_generated"] == 2 * len(soak["jobs"]) == 18
    assert soak["delta"]["batched_requests"] >= 2


@pytest.mark.parametrize("i", range(len(_jobs())), ids=_ids(_jobs()))
def test_serial_baseline_matches_jax(soak, i):
    out, want = soak["serial"][i], soak["want"][i]
    assert out["stage2_ran"] is (want.stage2 is not None)
    got = serve_bench.decode(out["image"])
    assert got.shape == want.image.shape
    assert np.abs(got.astype(int) - want.image.astype(int)).max() <= 1
