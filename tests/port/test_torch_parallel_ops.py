"""The port's multi-device building blocks on CPU ranks (``gloo``): the
mesh, the collectives, the spatially split layers and UNet forward, and
sequence-sharded attention against JAX ``flash_attention_seq_sharded``.

One ``launch.spawn`` per world size serves every case of that size."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omg_tpu.models import unet as junet
from omg_tpu.ops import flash_attention as jfa
from omg_tpu.parallel import mesh as jmesh
from omg_tpu.pipelines import sdxl as jsdxl
from omg_tpu_torch import from_jax
from omg_tpu_torch.models import unet
from omg_tpu_torch.nn import layers
from omg_tpu_torch.ops import flash_attention as fa
from omg_tpu_torch.parallel import comm, launch, mesh as mesh_lib
from omg_tpu_torch.pipelines import sdxl

import torch_mesh_workers as workers
from torch_port_helpers import normal, numpy_params, t

LAYER_ATOL = 1e-5       # the spatial layers against the unsharded port
FORWARD_ATOL = 2e-4     # the UNet forward (tests/test_parallel.py)
ATTENTION_ATOL = 2e-5   # tests/test_parallel.py:111-126


def _layer_case():
    rng = np.random.default_rng(3)
    cfg = jsdxl.tiny_config().unet
    tids = np.tile(np.asarray([[64, 64, 0, 0, 64, 64]], np.float32), (2, 1))
    return {
        "x": normal(rng, 2, 8, 8, 5),
        "conv_w": normal(rng, 16, 8, 3, 3, scale=0.2),
        "conv_b": normal(rng, 16, scale=0.1),
        "gn_w": 1 + normal(rng, 8, scale=0.1),
        "gn_b": normal(rng, 8, scale=0.1),
        "unet": numpy_params(junet.init_params, cfg, seed=4),
        "unet_inputs": (normal(rng, 2, 8, 8, 4),
                        normal(rng, 2, 77, cfg.cross_attention_dim),
                        normal(rng, 2, 16), tids),
    }


def _attention_case():
    qkv = np.asarray(jax.random.normal(jax.random.PRNGKey(9),
                                       (3, 2, 4, 512, 64), jnp.float32))
    return {"q": qkv[0], "k": qkv[1], "v": qkv[2]}


CASES = {
    2: {"layers": True, "attention_grids": [(1, 2)]},
    3: {},
    4: {"layers": True},
    8: {"attention_grids": [(2, 4)]},
}


@pytest.fixture(scope="module")
def inputs():
    return {"layers": _layer_case(), "attention": _attention_case()}


@pytest.fixture(scope="module")
def runs(inputs):
    """Rank results, spawned lazily once per world size."""
    cache = {}

    def get(n):
        if n not in cache:
            case = {"attention_grids": CASES[n].get("attention_grids", [])}
            if CASES[n].get("layers"):
                case["layers"] = inputs["layers"]
            if case["attention_grids"]:
                case["attention"] = inputs["attention"]
            cache[n] = launch.spawn(workers.ops_rank, n, backend="gloo",
                                    args=(case,), timeout=120)
        return cache[n]
    return get


@pytest.mark.parametrize("n,data,model,want", [
    (8, None, 2, (4, 2)), (8, 2, None, (2, 4)), (4, None, None, (4, 1)),
    (4, 2, 2, (2, 2)), (2, 1, 2, (1, 2)), (3, 1, None, (1, 3))])
def test_mesh_split(n, data, model, want):
    assert mesh_lib.split(n, data=data, model=model) == want
    assert jmesh.make_mesh(n, data=data, model=model).devices.shape == want


def test_mesh_split_refuses_a_bad_grid():
    """tests/test_parallel.py:13-19's error, without a world."""
    with pytest.raises(ValueError, match="mesh 3x2 != 8 devices"):
        mesh_lib.split(8, data=3)
    with pytest.raises(ValueError):
        jmesh.make_mesh(8, data=3)


@pytest.mark.parametrize("n,parts", [(8, 3), (6, 4), (7, 7), (2, 1)])
def test_split_matches_tensor_split(n, parts):
    want = [len(c) for c in torch.tensor_split(torch.arange(n), parts)]
    got = [mesh_lib.shard_range(n, parts, i) for i in range(parts)]
    assert [hi - lo for lo, hi in got] == want
    assert got[0][0] == 0 and got[-1][1] == n
    assert all(a[1] == b[0] for a, b in zip(got, got[1:]))


@pytest.mark.parametrize("nq,nk,d,device,seq_local,want", [
    (2048, 4096, 64, "cuda", True, True),      # 2-way seq, level 1
    (256, 1024, 64, "cuda", True, True),       # 4-way seq, level 2
    (255, 1020, 64, "cuda", True, False),      # under the 256-row floor
    (494, 988, 128, "cuda", True, True),
    (512, 1024, 40, "cuda", True, False),      # head dim
    (2048, 4096, 64, "cpu", True, False),      # off CUDA: plain
    (2048, 4096, 64, "cuda", False, False),    # not square without seq_local
    (4096, 4096, 64, "cuda", False, True),
])
def test_seq_local_gate(nq, nk, d, device, seq_local, want):
    """JAX ``use_flash``'s seq-local rule (``:299-300``), decided by device."""
    assert fa.use_flash(nq, nk, d, device, seq_local=seq_local) is want


def _expected_comm(n):
    xs = [workers.comm_inputs(r) for r in range(n)]
    sizes = mesh_lib.Split(2 * n - 1, _fake_group(n)).sizes
    g = torch.arange(4 * n * 6, dtype=torch.float64).reshape(1, 2, 4 * n, 3)
    gp1 = torch.nn.functional.pad(g, (0, 0, 1, 1))
    gp2 = torch.nn.functional.pad(g, (0, 0, 2, 2))
    out = []
    for r in range(n):
        halo1 = torch.cat([gp1[..., 4 * r:4 * r + 1, :],
                           gp1[..., 4 * r + 5:4 * r + 6, :]], dim=-2)
        halo2 = torch.cat([gp2[..., 4 * r:4 * r + 2, :],
                           gp2[..., 4 * r + 6:4 * r + 8, :]], dim=-2)
        out.append({
            "gather": torch.cat(xs, dim=1).numpy(),
            "uneven": torch.cat([torch.full((s, 2), float(i))
                                 for i, s in enumerate(sizes)]).numpy(),
            "sum": sum(xs).numpy(),
            "bcast": xs[n - 1].numpy(),
            "halo1": halo1.numpy(), "halo2": halo2.numpy()})
    return out


def _fake_group(n, index=0):
    """A group object for code that only reads its shape (no world)."""
    return comm.Group(tuple(range(n)), index)


@pytest.mark.parametrize("n", [2, 3, 4])
def test_comm_matches_slicing(runs, n):
    """all_gather (equal and uneven), all_reduce_sum, broadcast_rows and
    halo_rows on n CPU ranks equal slicing one tensor in one process."""
    got, want = runs(n), _expected_comm(n)
    for r in range(n):
        for key, w in want[r].items():
            np.testing.assert_array_equal(got[r]["comm"][key], w,
                                          err_msg=f"{key} on rank {r}")


@pytest.mark.parametrize("n", [2, 3, 4])
def test_mesh_coordinates_and_groups(runs, n):
    for r, res in enumerate(runs(n)):
        for shape, coords, data_ranks, model_ranks, flat in \
                res["comm"]["grids"]:
            data, model = shape[mesh_lib.DATA_AXIS], shape[mesh_lib.MODEL_AXIS]
            d, m = divmod(r, model)
            assert data * model == n and coords == (d, m)
            assert data_ranks == tuple(i * model + m for i in range(data))
            assert model_ranks == tuple(d * model + j for j in range(model))
            assert flat == tuple(range(n))


@pytest.mark.parametrize("n", [2, 3, 4])
def test_latency_mesh(runs, n):
    """JAX ``make_latency_mesh``: (2, n/2) for even n, else (1, n); it
    raises when the world is smaller than n."""
    want = jmesh.make_latency_mesh(n).devices.shape
    for res in runs(n):
        assert res["comm"]["latency"] == want
        assert res["comm"]["latency_error"] == (
            f"latency mesh needs {n + 1} devices; only {n} visible")


def _unsharded_layers(case):
    x = t(case["x"])
    out = {}
    for stride in (1, 2):
        conv = layers.Conv2d(8, 16, 3, stride=stride)
        with torch.no_grad():
            conv.weight.copy_(t(case["conv_w"]))
            conv.bias.copy_(t(case["conv_b"]))
        out[f"conv{stride}"] = conv(x).numpy()
    gn = layers.GroupNorm(8, 4)
    with torch.no_grad():
        gn.weight.copy_(t(case["gn_w"]))
        gn.bias.copy_(t(case["gn_b"]))
    out["group_norm"] = gn(x).numpy()
    model = from_jax.load_into(
        unet.UNet2DConditionModel(sdxl.tiny_config().unet), case["unet"])
    sample, ehs, pooled, tids = (t(a) for a in case["unet_inputs"])
    with torch.no_grad():
        out["unet"] = model(sample, 981, ehs, text_embeds=pooled,
                            time_ids=tids).numpy()
    return out


@pytest.fixture(scope="module")
def unsharded_layers(inputs):
    return _unsharded_layers(inputs["layers"])


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("key,axis,atol", [
    ("conv1", 2, LAYER_ATOL), ("conv2", 2, LAYER_ATOL),
    ("group_norm", 2, LAYER_ATOL), ("unet", 1, FORWARD_ATOL)])
def test_spatial_layers_match_unsharded(runs, unsharded_layers, n, key, axis,
                                        atol):
    """Halo convs (stride 1 and the stride-2 downsample), group norm with
    statistics over the group, and the tiny UNet forward, H split over n
    ranks, against the unsharded port."""
    got = np.concatenate([r["layers"][key] for r in runs(n)], axis=axis)
    np.testing.assert_allclose(got, unsharded_layers[key], atol=atol)


def test_stride2_split_refuses_odd_rows():
    conv = layers.Conv2d(2, 2, 3, stride=2)
    with pytest.raises(ValueError, match="even count"):
        conv(torch.zeros(1, 2, 3, 4), _fake_group(2))


@pytest.mark.parametrize("n,data,model", [(2, 1, 2), (8, 2, 4)])
def test_seq_sharded_attention_matches_jax(runs, inputs, n, data, model):
    """K1b's wrapper on CPU ranks (its plain version) and the attention's
    seq-sharded route, against JAX ``flash_attention_seq_sharded``
    (interpret mode) on the same mesh."""
    case = inputs["attention"]
    mesh = jmesh.make_mesh(n, data=data, model=model)
    want = np.asarray(jfa.flash_attention_seq_sharded(
        *(jnp.asarray(case[k]) for k in "qkv"), mesh=mesh,
        lane_axis=jmesh.DATA_AXIS, seq_axis=jmesh.MODEL_AXIS,
        interpret=True))
    res = [r[f"attention{data}x{model}"] for r in runs(n)]
    for key in ("wrapper", "sdpa"):
        rows = [np.concatenate([res[d * model + m][key] for m in range(model)],
                               axis=2) for d in range(data)]
        np.testing.assert_allclose(np.concatenate(rows), want,
                                   atol=ATTENTION_ATOL, err_msg=key)
    assert all(r["plain_calls"] == 1 for r in res)
