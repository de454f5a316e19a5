"""Tensor parallelism (``parallel/sharding.py``): the port's plan against
``omg_tpu.parallel.sharding.unet_tp_sharding``'s tree key by key (plain
and int8); on four CPU ranks (``gloo``) a UNet forward with its attention
split over the model axis against the unsharded one, where the model
size divides the heads and where it does not, with LoRA, P2P and IP
tokens, and after W8A8 (a split int8 linear bit-equal to the unsplit one,
the whole forward within the int8 rounding-flip bound of
test_torch_quant.py); and ``dryrun_multichip(4, device="cpu")``."""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding

from omg_tpu import config as jconfig
from omg_tpu.models import unet as junet
from omg_tpu.ops.quant import quantize_unet_params
from omg_tpu.parallel import mesh as jmesh
from omg_tpu.parallel import sharding as jsharding
from omg_tpu_torch import from_jax
from omg_tpu_torch.control import p2p
from omg_tpu_torch.models import unet
from omg_tpu_torch.ops import quant
from omg_tpu_torch.parallel import dryrun, launch, mesh as mesh_lib
from omg_tpu_torch.parallel import sharding

import torch_mesh_workers as workers
from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse)
from torch_port_helpers import mid_block_lora, normal

ATOL = 2e-4                 # fp32: partial products summed in another order
FLIP_REL = 2 / 127          # test_torch_quant.py: one or two int8 flips


def _jax_specs(tree) -> dict:
    """JAX sharding tree -> {the port's state-dict name: spec in the
    port's layout} (a 2-D kernel [in, out] is [out, in] here)."""
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, NamedSharding))
    out = {}
    for path, sh in flat:
        keys = [getattr(p, "key", getattr(p, "idx", None)) for p in path]
        name = from_jax._torch_path(keys)
        spec = tuple(sh.spec)
        out[name] = spec, keys
    return out


@pytest.mark.parametrize("layout", ["plain", "int8"])
def test_plan_matches_jax_tree(layout):
    """Every tensor's spec equals JAX's, after ``from_jax``'s renames and
    the [in, out] -> [out, in] transpose."""
    def init(key):
        params = junet.init_params(key, jconfig.tiny_unet())
        return quantize_unet_params(params) if layout == "int8" else params
    # the tree's structure and shapes, traced and not run
    params = jax.eval_shape(init, jax.random.PRNGKey(0))
    model = unet.UNet2DConditionModel(workers.tp_unet_config("tiny"))
    if layout == "int8":
        model = quant.quantize_unet(model)
    want = _jax_specs(jsharding.unet_tp_sharding(
        params, jmesh.make_mesh(8, model=2)))
    mesh = mesh_lib.Mesh(4, 2, 0, torch.device("cpu"), None, None, None)
    plan = sharding.unet_tp_sharding(model, mesh)
    assert plan.mesh is mesh
    assert set(plan.specs) == set(want)
    split = 0
    for name, (spec, keys) in want.items():
        ndim = model.state_dict()[name].dim()
        spec = spec + (None,) * (ndim - len(spec)) if spec else ()
        if ndim == 2 and spec:
            spec = spec[::-1]
        assert plan.specs[name] == spec, (name, keys)
        split += bool(spec)
    # q/k/v weights, to_out weights and (int8) the columns' scales
    per_attn = 4 if layout == "plain" else 7
    assert split == per_attn * 2 * 4
    assert set(sharding.replicated_like(model, mesh).specs.values()) == {()}


def _tp_inputs(ucfg, rng):
    dim = ucfg.block_out_channels[-1]
    return {"lora": mid_block_lora(rng, dim, ucfg.cross_attention_dim),
            "inputs": [normal(rng, 4, 8, 8, 4), normal(rng, 4, 77, 48),
                       normal(rng, 4, 16),
                       np.tile(np.float32([64, 64, 0, 0, 64, 64]), (4, 1)),
                       normal(rng, 4, 4, 48)],
            "linear_x": normal(rng, 2, 5, dim)}


@pytest.fixture(scope="module")
def tp_runs():
    """One spawn: the tiny UNet on a (2, 2) grid (model 2 divides its 8
    heads) and the two-level UNet on (1, 4) (model 4 divides 4 heads and
    not 6)."""
    rng = np.random.default_rng(70)
    case = {}
    for key, data, kind in (("tiny22", 2, "tiny"), ("mixed14", 1, "mixed")):
        case[key] = dict(data=data, unet=kind,
                         **_tp_inputs(workers.tp_unet_config(kind), rng))
    return case, launch.spawn(workers.tp_rank, 4, backend="gloo",
                              args=(case,), timeout=240)


def _reference(run):
    """The unsharded forwards (and linears) of ``run``, as the ranks built
    them."""
    ucfg = workers.tp_unet_config(run["unet"])
    model = unet.init_params(torch.Generator().manual_seed(3), ucfg)
    ip = unet.init_ip_layers(torch.Generator().manual_seed(4), ucfg)
    lora = from_jax.lora_from_jax(run["lora"], device="cpu")
    sample, ehs, pooled, tids, ip_ctx = (workers.t(a) for a in run["inputs"])
    ctl = p2p.P2PControl.build(["a", "a"], 4, self_replace_steps=0.5,
                               width=4, height=4)
    out = {}
    for name, m in (("plain", model), ("w8a8", quant.quantize_unet(model))):
        with torch.no_grad():
            out[name] = m(sample, 961, ehs, text_embeds=pooled,
                          time_ids=tids, lora=lora, control=ctl.at_step(1),
                          ip_adapter=ip, ip_context=ip_ctx,
                          ip_scale=0.7).numpy()
            if name == "w8a8":
                blk = m.mid_block.attentions[0].transformer_blocks[0]
                x = workers.t(run["linear_x"])
                out["q_linear"] = blk.attn1.to_q(x).numpy()
                out["out_linear"] = blk.attn1.to_out[0](x).numpy()
                out["q_rows"] = blk.attn1.to_q.weight_q.shape[0]
    return out


@pytest.mark.parametrize("key", ["tiny22", "mixed14"])
def test_tp_forward_matches_unsharded(tp_runs, key):
    """Every rank's forward equals the unsharded one within 2e-4 in fp32;
    the quantized forward within the rounding-flip bound of the quantized
    unsharded one, and its split int8 ``to_q`` (columns) and ``to_out``
    (rows, activation scale and int32 sums over the group) bit for bit."""
    case, ranks = tp_runs
    run = case[key]
    want = _reference(run)
    model = mesh_lib.split(4, data=run["data"])[1]
    for r, res in enumerate(ranks):
        got = res[key]
        np.testing.assert_allclose(got["plain"], want["plain"], atol=ATOL,
                                   err_msg=f"rank {r}")
        rel = (np.abs(got["w8a8"] - want["w8a8"]).max()
               / np.abs(want["w8a8"]).max())
        assert rel <= FLIP_REL, (r, rel)
        cols = mesh_lib.shard_range(want["q_rows"], model, r % model)
        np.testing.assert_array_equal(got["q_linear"],
                                      want["q_linear"][..., slice(*cols)])
        np.testing.assert_array_equal(got["out_linear"], want["out_linear"])
        assert got["q_rows"] == cols[1] - cols[0]
    # the split mattered: the quantized forward is not the float one
    assert np.abs(want["w8a8"] - want["plain"]).max() > ATOL


def test_dryrun_multichip_on_cpu_ranks(capsys):
    """``dryrun_multichip(4)`` on CPU ranks: a (2, 2) grid, DP x TP step,
    the two-stage program and LCM with one request per rank; one line per
    scenario, each after its checks."""
    lines = dryrun.dryrun_multichip(4, device="cpu")
    assert capsys.readouterr().out.splitlines() == lines
    assert len(lines) == 3
    assert all(line.startswith("dryrun_multichip OK: ") for line in lines)
    assert "mesh 2x2 (data x model)" in lines[0]
    assert "to_q rows 32 of 64" in lines[0]
