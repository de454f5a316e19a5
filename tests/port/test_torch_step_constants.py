"""The denoise step's per-step constants, made on the device without a
host-device copy, against the copies they replace: the sigma of
``scale_model_input``, the UNet's timestep, the guidance scale of
``cfg_combine``, P2P's lane indices (``P2PControl.lane_index``) and the
region fusion's copy-B rows. Each new form must give the same bits.

The "copy" forms below are the replaced code, kept here as the
reference. The last test repeats the comparisons on an NVIDIA GPU and
skips elsewhere. This file imports no jax, so on the GPU machine it runs
alone:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/port/test_torch_step_constants.py
"""

import copy

import pytest
import torch

from omg_tpu_torch import config
from omg_tpu_torch.control import p2p, regions
from omg_tpu_torch.diffusion import sampling, schedulers
from omg_tpu_torch.models import unet as unet_lib
from omg_tpu_torch.nn import attention, layers
from omg_tpu_torch.utils import profiling

DTYPES = {"bf16": torch.bfloat16, "fp32": torch.float32}


def bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_scale_model_input_at_every_sigma(dtype):
    dt = DTYPES[dtype]
    sched = schedulers.make_schedule("euler", 50)
    x = torch.randn((2, 8, 8, 4), generator=torch.Generator().manual_seed(0)
                    ).to(dt)
    for i in range(sched.num_steps):
        sigma = sched.sigmas[i].to(dtype=dt)        # the copy's value
        assert bits_equal(
            torch.full((), float(sched.sigmas[i]), dtype=dt), sigma)
        want = x / torch.sqrt(sigma * sigma + 1.0)
        assert bits_equal(schedulers.scale_model_input(sched, x, i), want), i


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_a_fill_rounds_as_the_fp32_tensor(dtype):
    """A double that holds an fp32 value rounds to the target dtype as
    the fp32 tensor does, ties and subnormals included."""
    dt = DTYPES[dtype]
    g = torch.Generator().manual_seed(1)
    vals = torch.cat([
        torch.randn(2000, generator=g) * 10.0 ** torch.randint(
            -6, 6, (2000,), generator=g).float(),
        # finite bf16 ties: the low 16 bits exactly half way
        (torch.randint(1, 0x7F80, (500,), generator=g, dtype=torch.int32)
         * 2 ** 16 + 2 ** 15).view(torch.float32),
        torch.tensor([1e-40, -3e-39, 0.0, -0.0, 7.5, 1e30])])
    for v in vals:
        assert bits_equal(torch.full((), float(v), dtype=dt), v.to(dt)), v


def _copy_time_embeddings(model, cfg, timestep, text_embeds, time_ids):
    """``unet.time_embeddings`` as it was, with the timestep copied."""
    b = text_embeds.shape[0]
    t = torch.as_tensor(timestep, dtype=torch.float32,
                        device=text_embeds.device).expand(b)
    t_emb = layers.timestep_embedding(t, cfg.block_out_channels[0])
    te = model.time_embedding
    temb = te.linear_2(torch.nn.functional.silu(
        te.linear_1(t_emb.to(cfg.dtype))))
    ids = time_ids.float().reshape(-1)
    id_emb = layers.timestep_embedding(
        ids, cfg.addition_time_embed_dim).reshape(b, -1)
    add = torch.cat([text_embeds.float(), id_emb], dim=-1)
    ae = model.add_embedding
    aemb = ae.linear_2(torch.nn.functional.silu(
        ae.linear_1(add.to(cfg.dtype))))
    return temb + aemb


@pytest.fixture(scope="module")
def tiny_unet():
    cfg = config.tiny_unet()
    with torch.inference_mode():
        return cfg, unet_lib.init_params(torch.Generator().manual_seed(0),
                                         cfg)


@pytest.mark.parametrize("timestep", [1, 21, 261, 501, 981, 999])
def test_time_embeddings(timestep, tiny_unet):
    cfg, model = tiny_unet
    g = torch.Generator().manual_seed(timestep)
    pdim = (model.add_embedding.linear_1.weight.shape[1]
            - 6 * cfg.addition_time_embed_dim)
    text = torch.randn((3, pdim), generator=g).to(cfg.dtype)
    tids = torch.tensor([[1024.0, 1024, 0, 0, 1024, 1024]]).expand(3, 6)
    with torch.inference_mode():
        got = unet_lib.time_embeddings(model, cfg, timestep, text, tids)
        want = _copy_time_embeddings(model, cfg, timestep, text, tids)
    assert bits_equal(got, want)


@pytest.mark.parametrize("scale", [7.5, 5.0, 3.3, 1.0 / 3.0, "tensor"])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_cfg_combine_with_a_host_scale(scale, dtype):
    dt = DTYPES[dtype]
    g = (torch.tensor(7.5, dtype=torch.float32) if scale == "tensor"
         else scale)
    pred = torch.randn((4, 8, 8, 4), generator=torch.Generator().manual_seed(
        2)).to(dt)
    uncond, cond = pred.chunk(2, dim=0)
    want = uncond + torch.as_tensor(g, dtype=dt) * (cond - uncond)
    assert bits_equal(sampling.cfg_combine(pred, g), want)


def test_fuse_region_noise_takes_copy_b_by_a_slice():
    g = torch.Generator().manual_seed(3)
    noise = torch.randn((4, 8, 8, 4), generator=g).to(torch.bfloat16)
    preds = torch.randn((2, 2, 8, 8, 4), generator=g).to(torch.bfloat16)
    masks = torch.zeros((2, 8, 8))
    masks[0, :, :4] = 1.0
    masks[1, 2:6, 4:] = 1.0
    masks = masks.to(torch.bfloat16)
    new = regions.fuse_region_edit(noise[[1, 3]], preds, masks, active=True)
    want = torch.stack([noise[0], new[0], noise[2], new[1]])
    assert bits_equal(
        regions.fuse_region_noise(noise, preds, masks, active=True), want)


STEPS = 50
# (batch, at_step keyword arguments): the 3+2K layout (0, 2), the
# reference's 4+2K layout (2, 3), and two requests' 7 lanes side by side
LAYOUTS = {
    "pair_0_2": (7, dict(src_lane=0, dst_lane=2)),
    "pair_2_3": (8, dict(src_lane=2, dst_lane=3)),
    "pairs_of_two": (14, dict(pairs=[(0, 2), (7, 9)])),
}


def _controller():
    return p2p.P2PControl.build(["a man and a woman"] * 2, STEPS,
                                width=2, height=2)


def _copy_self_lane_qk(ctl, q, k):
    """``self_lane_qk`` as it was: the row index copied each call."""
    if not ctl._in_window():
        return q, k
    rows = list(range(q.shape[0]))
    for s, d in ctl.pairs:
        rows[d] = s
    idx = torch.as_tensor(rows, device=q.device)
    return q.index_select(0, idx), k.index_select(0, idx)


def _copy_cross_lane_out(ctl, out, q, k, v, sdpa_fn):
    """``cross_lane_out`` as it was: both lane lists copied each call."""
    src = torch.as_tensor([s for s, _ in ctl.pairs], device=q.device)
    dst = torch.as_tensor([d for _, d in ctl.pairs], device=q.device)
    new = ctl._cross_edit(q[src], k[src], q[dst], k[dst], v[dst], sdpa_fn)
    return out.index_copy(0, dst, new.to(out.dtype))


def _qkv(b: int, n: int, seed: int) -> tuple:
    """bf16 [b, 2, n, 8] q/k/v as the attention hands them over: strided
    views of one [b, n, 3 * 16] product."""
    g = torch.Generator().manual_seed(seed)
    y = torch.randn((b, n, 48), generator=g).to(torch.bfloat16)
    return tuple(t.unflatten(-1, (-1, 8)).transpose(1, 2)
                 for t in y.chunk(3, dim=-1))


@pytest.mark.parametrize("step", [5, 30], ids=["in_window", "outside"])
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_p2p_edits_by_the_memoised_index(layout, step):
    batch, kw = LAYOUTS[layout]
    ctl = _controller().at_step(step, **kw)
    assert ctl._in_window() == (step == 5)
    q, k, _ = _qkv(batch, 4, seed=step)
    got, want = ctl.self_lane_qk(q, k), _copy_self_lane_qk(ctl, q, k)
    assert all(bits_equal(a, b) for a, b in zip(got, want))
    q, _, _ = _qkv(batch, 4, seed=step + 1)
    _, k, v = _qkv(batch, 77, seed=step + 2)
    out = attention.sdpa(q, k, v)
    assert bits_equal(ctl.cross_lane_out(out, q, k, v, attention.sdpa),
                      _copy_cross_lane_out(ctl, out, q, k, v,
                                           attention.sdpa))


def test_a_request_uploads_each_lane_index_once():
    """Over a whole run of steps, each layout's index goes to the device
    in one counted copy, on the first step that asks; the controllers of
    every later step reuse it."""
    ctl = _controller()
    with profiling.request("x"):
        for i in profiling.steps(0, STEPS):
            for name, (batch, kw) in LAYOUTS.items():
                step = ctl.at_step(i, **kw)
                q, k, v = _qkv(batch, 4, seed=i)
                for _ in range(3):
                    step.self_lane_qk(q, k)
                    step.cross_lane_out(attention.sdpa(q, k, v), q, k, v,
                                        attention.sdpa)
    req = profiling.REQUESTS[-1]
    syncs = [req.total(s, "sync") for s in req.spans if s.name == "step"]
    assert syncs == [len(LAYOUTS)] + [0] * (STEPS - 1)
    assert len(ctl._lane_index) == len(LAYOUTS)
    for (pairs, batch, _), idx in ctl._lane_index.items():
        rows = list(range(batch))
        for s, d in pairs:
            rows[d] = s
        assert idx.dtype == torch.int64 and idx.tolist() == (
            [s for s, _ in pairs] + [d for _, d in pairs] + rows)
    # another controller (another request) uploads its own
    assert not _controller()._lane_index


@pytest.mark.cuda
def test_the_forms_match_the_copies_on_the_card(tiny_unet):
    """The same comparisons with the card's fills, casts and index
    kernels: the sigmas of a 50-step schedule, the guidance scale, the
    timestep and P2P's edits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the card's fills and copies")
    dev = torch.device("cuda")
    sched = schedulers.make_schedule("euler", STEPS)
    g = torch.Generator().manual_seed(4)
    for dt in DTYPES.values():
        x = torch.randn((2, 8, 8, 4), generator=g).to(dev, dt)
        for i in range(sched.num_steps):
            sigma = sched.sigmas[i].to(device=dev, dtype=dt)
            assert bits_equal(schedulers.scale_model_input(sched, x, i),
                              x / torch.sqrt(sigma * sigma + 1.0)), i
        pred = torch.randn((4, 8, 8, 4), generator=g).to(dev, dt)
        uncond, cond = pred.chunk(2, dim=0)
        for scale in (7.5, 3.3, torch.tensor(7.5)):
            want = uncond + torch.as_tensor(scale, device=dev, dtype=dt) * (
                cond - uncond)
            assert bits_equal(sampling.cfg_combine(pred, scale), want)
    cfg, model = tiny_unet
    model = copy.deepcopy(model).to(dev)
    pdim = (model.add_embedding.linear_1.weight.shape[1]
            - 6 * cfg.addition_time_embed_dim)
    text = torch.randn((3, pdim), generator=g).to(dev, cfg.dtype)
    tids = torch.tensor([[1024.0, 1024, 0, 0, 1024, 1024]],
                        device=dev).expand(3, 6)
    with torch.inference_mode():
        for t in (1, 261, 981):
            assert bits_equal(
                unet_lib.time_embeddings(model, cfg, t, text, tids),
                _copy_time_embeddings(model, cfg, t, text, tids))
    for batch, kw in LAYOUTS.values():
        for step in (5, 30):
            ctl = _controller().at_step(step, **kw)
            q, k, v = (t.to(dev) for t in _qkv(batch, 4, seed=step))
            got, want = ctl.self_lane_qk(q, k), _copy_self_lane_qk(ctl, q, k)
            assert all(bits_equal(a, b) for a, b in zip(got, want))
            _, k, v = (t.to(dev) for t in _qkv(batch, 77, seed=step + 1))
            out = attention.sdpa(q, k, v)
            assert bits_equal(
                ctl.cross_lane_out(out, q, k, v, attention.sdpa),
                _copy_cross_lane_out(ctl, out, q, k, v, attention.sdpa))
