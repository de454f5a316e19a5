"""``OMG(mesh=...).generate``, the multi-device latency mode, on four CPU
ranks (``gloo``) against the JAX engine's mesh mode on four virtual
devices and against the port on one device, exact and with DeepCache;
and the tokenizer repair that lets ranks (and runs) agree on a prompt's
ids."""

import os
import pathlib
import subprocess
import sys

import jax
import numpy as np
import pytest

from omg_tpu.parallel import mesh as jmesh
from omg_tpu.pipelines import omg as jomg
from omg_tpu.pipelines import sdxl as jsdxl
from omg_tpu_torch import from_jax
from omg_tpu_torch.parallel import launch
from omg_tpu_torch.pipelines import omg, sdxl
from omg_tpu_torch.text.tokenizer import ToyTokenizer

import torch_mesh_workers as workers
from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse)
from torch_port_helpers import (left_right_masks, mid_block_lora, normal,
                                tiny_sdxl_numpy, to_jax)

ROOT = pathlib.Path(__file__).resolve().parents[2]
PROMPT = "photo of the man and the woman at the beach"
STEPS = 4
CACHE_INTERVAL = 2


@pytest.fixture(scope="module")
def runs():
    """The same request through the JAX mesh engine, the port on one
    device, and the port's mesh engine on 4 ranks (2 x 2 grid: 64x64, so
    the deepest level's 4 rows split over the model axis)."""
    tree = tiny_sdxl_numpy(seed=10)
    rng = np.random.default_rng(11)
    dim = jsdxl.tiny_config().unet.block_out_channels[-1]
    ctx = jsdxl.tiny_config().unet.cross_attention_dim
    concepts = [mid_block_lora(rng, dim, ctx),
                mid_block_lora(rng, dim, ctx, rank=2)]
    style = mid_block_lora(rng, dim, ctx, rank=3)
    kw = dict(negative_prompt="ugly", seed=14, height=64, width=64,
              prompt_rewrite="[photo of the man]-*-[ugly]|"
                             "[photo of the woman]-*-[blurry]",
              initial_noise=normal(rng, 1, 8, 8, 4))
    tok = ToyTokenizer()                # one instance, both engines
    jeng = jomg.OMG(cfg=jsdxl.tiny_config(), params=to_jax(tree),
                    tokenizer=tok, tokenizer_2=tok,
                    mask_provider=left_right_masks, num_steps=STEPS,
                    mesh=jmesh.make_mesh(4, data=2))
    want = jeng.generate(PROMPT, concept_loras=[to_jax(c) for c in concepts],
                         style_lora=to_jax(style), **kw)
    # DeepCache on the mesh (tests/test_omg_pipeline.py:460-481)
    jeng = jomg.OMG(cfg=jsdxl.tiny_config(), params=to_jax(tree),
                    tokenizer=tok, tokenizer_2=tok,
                    mask_provider=left_right_masks, num_steps=STEPS,
                    mesh=jmesh.make_mesh(4, data=2),
                    cache_interval=CACHE_INTERVAL)
    want_dc = jeng.generate(PROMPT,
                            concept_loras=[to_jax(c) for c in concepts],
                            style_lora=to_jax(style), **kw)
    teng = omg.OMG(cfg=sdxl.tiny_config(),
                   params=from_jax.sdxl_from_jax(tree, sdxl.tiny_config(),
                                                 device="cpu"),
                   tokenizer=tok, tokenizer_2=tok,
                   mask_provider=left_right_masks, num_steps=STEPS)
    tkw = dict(kw, concept_loras=[from_jax.lora_from_jax(c, device="cpu")
                                  for c in concepts],
               style_lora=from_jax.lora_from_jax(style, device="cpu"))
    single = teng.generate(PROMPT, **tkw)
    single_dc = teng.generate(PROMPT, cache_interval=CACHE_INTERVAL, **tkw)
    case = {"data": 2, "steps": STEPS, "prompt": PROMPT,
            "params": tuple(tree), "cache_interval": CACHE_INTERVAL,
            "kw": dict(kw, concept_loras=concepts, style_lora=style)}
    ranks = launch.spawn(workers.omg_rank, 4, backend="gloo", args=(case,),
                         timeout=240)
    return want, single, ranks, want_dc, single_dc


def _close(got, want, what):
    assert got.dtype == np.uint8 and got.shape == want.shape, what
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1, what


@pytest.mark.parametrize("name", ["stage1", "stage2"])
def test_mesh_generate_matches_jax_mesh(runs, name):
    want, _, ranks, _, _ = runs
    assert getattr(want, name) is not None
    for r, res in enumerate(ranks):
        _close(res[name], getattr(want, name), f"{name} rank {r}")
        for g, w in zip(res["masks"], want.masks):
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("name", ["stage1", "stage2"])
def test_mesh_generate_matches_one_device(runs, name):
    _, single, ranks, _, _ = runs
    for r, res in enumerate(ranks):
        _close(res[name], getattr(single, name), f"{name} rank {r}")


def test_mesh_ranks_agree_and_split_the_sequence(runs):
    """Every rank returns the same images, and stage 1 ran its
    self-attention sequence-sharded (not the lane-only layout)."""
    _, _, ranks, _, _ = runs
    for res in ranks[1:]:
        for name in ("stage1", "stage2"):
            np.testing.assert_array_equal(res[name], ranks[0][name])
    assert all(res["seq_calls"] > 0 for res in ranks)


@pytest.mark.parametrize("name", ["stage1", "stage2"])
def test_mesh_deepcache_matches_jax_mesh_and_one_device(runs, name):
    """``OMG(mesh=..., cache_interval=2)`` on 4 ranks against the JAX mesh
    engine with the same interval and against the port's one-device
    engine with the request's interval: the shallow steps run H-split in
    stage 1 and lane-split in stage 2."""
    _, _, ranks, want_dc, single_dc = runs
    for r, res in enumerate(ranks):
        got = res["deepcache"][name]
        _close(got, getattr(want_dc, name), f"{name} rank {r} vs JAX")
        _close(got, getattr(single_dc, name), f"{name} rank {r} vs one")
        np.testing.assert_array_equal(got, ranks[0]["deepcache"][name])
    assert np.abs(ranks[0]["deepcache"]["stage2"].astype(int)
                  - ranks[0]["stage2"].astype(int)).max() > 0


def _ids_under_hash_seed(module: str, seed: str) -> str:
    code = (f"from {module} import ToyTokenizer\n"
            f"print(ToyTokenizer()([{PROMPT!r}]).tolist())\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=str(ROOT), PYTHONHASHSEED=seed)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    return proc.stdout


def test_toy_tokenizer_ids_survive_the_hash_seed():
    """The fault: the JAX package's ToyTokenizer ids come from Python's
    salted ``hash``, so two processes map one prompt to different ids. The
    port's ToyTokenizer hashes with BLAKE2b and gives the same ids in every
    process."""
    jax_copy = {_ids_under_hash_seed("omg_tpu.text.tokenizer", s)
                for s in ("1", "2")}
    assert len(jax_copy) == 2
    port = {_ids_under_hash_seed("omg_tpu_torch.text.tokenizer", s)
            for s in ("1", "2")}
    assert len(port) == 1
    assert port == {str(ToyTokenizer()([PROMPT]).tolist()) + "\n"}
