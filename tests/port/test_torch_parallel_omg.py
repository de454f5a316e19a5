"""``OMG(mesh=...).generate``, the multi-device latency mode, on four CPU
ranks (``gloo``) against the JAX engine's mesh mode on four virtual
devices and against the port on one device; and the tokenizer repair that
lets ranks (and runs) agree on a prompt's ids."""

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
from torch_port_helpers import (left_right_masks, mid_block_lora, normal,
                                tiny_sdxl_numpy, to_jax)

ROOT = pathlib.Path(__file__).resolve().parents[2]
PROMPT = "photo of the man and the woman at the beach"
STEPS = 4


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
    teng = omg.OMG(cfg=sdxl.tiny_config(),
                   params=from_jax.sdxl_from_jax(tree, sdxl.tiny_config(),
                                                 device="cpu"),
                   tokenizer=tok, tokenizer_2=tok,
                   mask_provider=left_right_masks, num_steps=STEPS)
    single = teng.generate(PROMPT,
                           concept_loras=[
                               from_jax.lora_from_jax(c, device="cpu")
                               for c in concepts],
                           style_lora=from_jax.lora_from_jax(
                               style, device="cpu"), **kw)
    case = {"data": 2, "steps": STEPS, "prompt": PROMPT,
            "params": tuple(tree),
            "kw": dict(kw, concept_loras=concepts, style_lora=style)}
    ranks = launch.spawn(workers.omg_rank, 4, backend="gloo", args=(case,),
                         timeout=240)
    return want, single, ranks


def _close(got, want, what):
    assert got.dtype == np.uint8 and got.shape == want.shape, what
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1, what


@pytest.mark.parametrize("name", ["stage1", "stage2"])
def test_mesh_generate_matches_jax_mesh(runs, name):
    want, _, ranks = runs
    assert getattr(want, name) is not None
    for r, res in enumerate(ranks):
        _close(res[name], getattr(want, name), f"{name} rank {r}")
        for g, w in zip(res["masks"], want.masks):
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("name", ["stage1", "stage2"])
def test_mesh_generate_matches_one_device(runs, name):
    _, single, ranks = runs
    for r, res in enumerate(ranks):
        _close(res[name], getattr(single, name), f"{name} rank {r}")


def test_mesh_ranks_agree_and_split_the_sequence(runs):
    """Every rank returns the same images, and stage 1 ran its
    self-attention sequence-sharded (not the lane-only layout)."""
    _, _, ranks = runs
    for res in ranks[1:]:
        for name in ("stage1", "stage2"):
            np.testing.assert_array_equal(res[name], ranks[0][name])
    assert all(res["seq_calls"] > 0 for res in ranks)


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
