"""The port's InstantID against the plain fp32 reference the benchmark
holds it to (``benchmark/reference/instantid.py``), at a tiny size on the
CPU: seeded random weights in checkpoint layout
(``benchmark/weights_instantid.py``, every zero conv non-zero) loaded
through ``convert.convert_controlnet`` and ``convert.convert_ip_adapter``,
everything fp32.

The tiny UNet has attention at two widths (32 and 64), so an adapter
layer put on the wrong attn2 fails its shape or its numbers. Both sides
compute the same fp32 products in another order (the port fuses q/k/v
and k/v, batches lanes, splits heads and takes its own softmax path), so
each comparison allows a few hundred fp32 roundings carried through the
depth of the tiny models: 1e-4 relative on values of order one. The
IdentityNet's and the UNet's random weights double no error along the
way at this depth (the gaps read 1e-6 to 1e-5).

This file imports no jax.
"""

import json
import pathlib

import pytest
import torch

from benchmark import program, run, trace
from benchmark import generator as gen
from benchmark import weights_instantid as wi
from benchmark.entries import omg_instantid as entry
from benchmark.reference import instantid as ref_iid
from benchmark.tests import tiny_cells
from omg_tpu_torch import instantid as iid_lib
from omg_tpu_torch.models import unet as unet_lib
from omg_tpu_torch.utils import profiling

BENCH = pathlib.Path(__file__).resolve().parents[2] / "benchmark"
SEED = 11
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
    base = json.loads((BENCH / "configs" / "omg_instantid_sdxl.json")
                      .read_text())
    c = tiny_cells.tiny_config(base)
    two_width(c["unet"])
    two_width(c["identitynet"])
    return c


@pytest.fixture(scope="module")
def mix(cfg):
    m = json.loads((BENCH / "traffic" / "omg_instantid_closed_loop.json")
                   .read_text())
    m["faces"]["embedding_dim"] = cfg["resampler"]["embedding_dim"]
    return m


@pytest.fixture(scope="module")
def sds(cfg):
    return wi.state_dicts(cfg, SEED, "cpu")


@pytest.fixture(scope="module")
def port(cfg, sds):
    """(SDXLConfig, SDXLParams, InstantIDModels) through the converters."""
    scfg, params = program.build(cfg, SEED, "cpu")
    _, iid = entry.build_instantid(cfg, scfg, SEED, "cpu")
    return scfg, params, iid


def close(got: torch.Tensor, want: torch.Tensor) -> None:
    assert got.shape == want.shape
    gap = (got - want).abs().max() / want.abs().max()
    assert gap < RTOL, float(gap)


def test_the_adapter_file_is_in_diffusers_order(cfg, sds):
    """The drawn file lists the up blocks' IP layers before the mid
    block's: at two widths its j-th layer has the width of the j-th attn2
    of ``attn_processors``."""
    order = wi.attn2_paths(cfg["unet"])
    assert [p.split(".")[0] for p, _ in order] == \
        ["down_blocks"] * 2 + ["up_blocks"] * 4 + ["mid_block"]
    for j, (_, c) in enumerate(order):
        assert sds["ip_adapter"][f"ip_adapter.{2 * j + 1}.to_k_ip.weight"] \
            .shape[0] == c
    assert ref_iid.attn2_order(cfg["unet"]) == {
        p: j for j, (p, _) in enumerate(order)}


def test_resampler_tokens(cfg, sds, port):
    """The face tokens of an embedding and of a zero one (CFG rows)."""
    emb = torch.randn(cfg["resampler"]["embedding_dim"],
                      generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        got = iid_lib.encode_face_tokens(port[2].resampler_params, emb)
    want = ref_iid.face_tokens({k: v.float() for k, v in
                                sds["ip_adapter"].items()},
                               cfg["resampler"], emb)
    close(got, want)


def _inputs(cfg, b: int = 2, seed: int = 3) -> dict:
    g = torch.Generator().manual_seed(seed)
    u = cfg["unet"]
    h = w = cfg["pipeline"]["height"] // 8
    r = cfg["resampler"]
    return dict(
        x=torch.randn((b, 4, h, w), generator=g),
        ctx=torch.randn((b, 77, u["cross_attention_dim"]), generator=g),
        pooled=torch.randn((b, u["projection_class_embeddings_input_dim"]
                            - 6 * u["addition_time_embed_dim"]),
                           generator=g),
        tids=torch.tensor([[64.0, 64.0, 0.0, 0.0, 64.0, 64.0]]).expand(b, 6),
        tokens=torch.randn((b, r["num_queries"], r["output_dim"]),
                           generator=g),
        cond=torch.rand((b, 3, 8 * h, 8 * w), generator=g),
        t=701.0)


def test_identitynet_residuals(cfg, sds, port):
    """Every skip's residual and the mid's, at the IdentityNet scale."""
    a = _inputs(cfg)
    scale = cfg["pipeline"]["identitynet_scale"]
    with torch.no_grad():
        down, mid = port[2].identitynet_params(
            a["x"].permute(0, 2, 3, 1), a["t"], a["tokens"],
            a["cond"].permute(0, 2, 3, 1), text_embeds=a["pooled"],
            time_ids=a["tids"], conditioning_scale=scale)
    w_down, w_mid = ref_iid.controlnet(
        {k: v.float() for k, v in sds["identitynet"].items()},
        cfg["identitynet"], a["x"], a["t"], a["tokens"], a["pooled"],
        a["tids"], a["cond"], scale)
    assert len(down) == len(w_down) == len(
        wi.skip_channels(cfg["identitynet"]))
    for g, w in zip(down, w_down):
        close(g, w)
    close(mid, w_mid)


def test_unet_with_ip_tokens_and_residuals(cfg, sds, port):
    """The UNet with the IP branch in each attn2 and the IdentityNet's
    residuals added, against the reference's."""
    scfg, params, iid = port
    a = _inputs(cfg)
    unet_sd = {k: v.float() for k, v in program.weights.model_state_dicts(
        cfg, SEED, "cpu")["unet"].items()}
    res = ref_iid.controlnet(
        {k: v.float() for k, v in sds["identitynet"].items()},
        cfg["identitynet"], a["x"], a["t"], a["tokens"], a["pooled"],
        a["tids"], a["cond"], 0.8)
    with torch.no_grad():
        got = params.unet(a["x"].permute(0, 2, 3, 1), a["t"], a["ctx"],
                          text_embeds=a["pooled"], time_ids=a["tids"],
                          ip_adapter=iid.ip_adapter_layers,
                          ip_context=a["tokens"], ip_scale=0.8,
                          down_block_residuals=res[0],
                          mid_block_residual=res[1])
    ip = ref_iid.IP({k: v.float() for k, v in sds["ip_adapter"].items()},
                    cfg["unet"], a["tokens"], 0.8)
    want = ref_iid.unet(unet_sd, cfg["unet"], a["x"], a["t"], a["ctx"],
                        a["pooled"], a["tids"], ip=ip, residuals=res)
    close(got.permute(0, 3, 1, 2), want)
    # the branch and the residuals move the prediction far beyond RTOL
    plain = ref_iid.unet(unet_sd, cfg["unet"], a["x"], a["t"], a["ctx"],
                         a["pooled"], a["tids"])
    assert (plain - want).abs().max() > 100 * RTOL * want.abs().max()


@pytest.fixture(scope="module")
def generated(cfg, mix):
    """One request of ``OMG.generate(instantid=...)`` through the
    benchmark's entry, its scheduler steps and concept lanes kept."""
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


def test_a_fused_stage2_step(generated):
    """Stage 2's first and last steps (fused: after the fusion start) and
    stage 1's, each from the program's own latents: the guided prediction,
    the latents after the step, the concept lanes before fusion, the
    decodes (``entry.check``'s relative mean gaps)."""
    ctx, req, out, _ = generated
    gaps = entry.check(ctx, req, out)
    assert set(gaps) == {"eps_gap", "step_gap", "region_eps_gap",
                         "decode_gap_levels"}
    for k in ("eps_gap", "step_gap", "region_eps_gap"):
        assert gaps[k] < RTOL, (k, gaps[k])
    assert gaps["decode_gap_levels"] <= 0.5     # a truncation flip


def test_ip_kv_projections_and_the_identitynet_span(cfg, generated):
    """Each stage-2 step: one concept forward whose every attn2 computes
    ``to_k_ip`` and ``to_v_ip`` once, and the IdentityNet's ``controlnet``
    span before it; the resampler's span under the encode phase."""
    _, _, _, r = generated
    (stage2,) = r.children(r.root, "stage2")
    steps = r.children(stage2, "step")
    n_attn2 = unet_lib.num_cross_attention_layers(
        program.sdxl_config(cfg).unet)
    assert n_attn2 == 7
    assert [r.total(s, "ip.kv_projections") for s in steps] == \
        [2 * n_attn2] * len(steps)
    assert all([c.name for c in r.children(s)] == ["controlnet", "unet"]
               for s in steps)
    (encode,) = r.children(r.root, "encode")
    assert len(r.children(encode, "resampler")) == cfg["pipeline"]["concepts"]
    (stage1,) = r.children(r.root, "stage1")
    assert r.total(stage1, "ip.kv_projections") == 0


class _FakeEvent:
    """A CUDA event on a host clock."""
    clock = 0

    def __init__(self, enable_timing=False):
        self.at = None

    def record(self, stream=None):
        _FakeEvent.clock += 1
        self.at = _FakeEvent.clock

    def synchronize(self):
        pass

    def elapsed_time(self, end) -> float:
        return float(end.at - self.at)       # ms


def test_the_controlnet_span_is_timed(cfg, port, monkeypatch):
    """With CUDA events on (faked here on the host), the IdentityNet's
    ``controlnet`` span carries the device ns between its events."""
    monkeypatch.setattr(torch.cuda, "Event", _FakeEvent)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda d=None: "s")
    a = _inputs(cfg)
    with torch.no_grad(), profiling.request("probe", device="cuda"):
        port[2].identitynet_params(
            a["x"].permute(0, 2, 3, 1), a["t"], a["tokens"],
            a["cond"].permute(0, 2, 3, 1), text_embeds=a["pooled"],
            time_ids=a["tids"])
    r = profiling.REQUESTS[-1].resolve()
    (cn,) = r.children(r.root, "controlnet")
    assert cn.device_ns is not None and cn.device_ns > 0
