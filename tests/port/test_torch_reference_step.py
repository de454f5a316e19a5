"""The reference's 4-row step (``multiconcept_step``, ``denoise_multiconcept``,
``sample_stage``) against the JAX package's at the tiny config: stage 1
and stage 2 with P2P, with concept LoRAs, with a spatial ControlNet in
guess mode and under a guidance window, with the IP tokens and the
IdentityNet on the concept lanes, and under LCM (JAX's draws injected);
latents within 5e-4 (tests/test_golden.py's bound). Then the port's fast
paths against its own ``sample_stage``, as tests/test_multiconcept.py
holds JAX's, and the zero-concept stage 2 of the 4+2K program, which is
the 4-row step's loop."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omg_tpu import config as jconfig
from omg_tpu.control import p2p as jp2p
from omg_tpu.diffusion import schedulers as jsched
from omg_tpu.models import controlnet as jcn
from omg_tpu.models import unet as junet
from omg_tpu.pipelines import multiconcept as jmc
from omg_tpu.pipelines import sdxl as jsdxl
from omg_tpu_torch import config, from_jax
from omg_tpu_torch.control import p2p
from omg_tpu_torch.diffusion import schedulers
from omg_tpu_torch.pipelines import multiconcept as mc
from omg_tpu_torch.pipelines import sdxl

from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse)
from torch_port_helpers import (mid_block_lora, normal, numpy_params, t,
                                tiny_sdxl, to_jax)

LATENT_ATOL = 5e-4
H = W = 32
STEPS = 4
FUSION = 1
SEED = 23


@pytest.fixture(scope="module")
def setup():
    jp, tp = tiny_sdxl(seed=40)
    rng = np.random.default_rng(41)
    ucfg = jconfig.tiny_unet()
    d, dim = ucfg.cross_attention_dim, ucfg.block_out_channels[-1]
    ep, en = normal(rng, 1, 77, d), normal(rng, 1, 77, d)
    pp, pn = normal(rng, 1, 16), normal(rng, 1, 16)
    cep, cen = normal(rng, 1, 77, d), normal(rng, 1, 77, d)
    m = np.zeros((2, H // 8, W // 8), np.float32)
    m[0, :, :2], m[1, :, 2:] = 1.0, 1.0
    n_ip = junet.num_cross_attention_layers(ucfg)
    ip_tree = [{k: {"weight": normal(rng, d, dim, scale=d ** -0.5)}
                for k in ("to_k_ip", "to_v_ip")} for _ in range(n_ip)]
    cn_tree = numpy_params(jcn.init_params, jconfig.tiny_controlnet(), 42)
    return dict(
        jp=jp, tp=tp, arrays=(ep, pp, en, pn), concept=(cep, pp, cen, pn),
        masks=m, noise=normal(rng, 1, H // 8, W // 8, 4),
        loras=[mid_block_lora(rng, dim, d), mid_block_lora(rng, dim, d, 2)],
        ip_tree=ip_tree, ip_tokens=[normal(rng, 2, 4, d), normal(rng, 2, 4, d)],
        cn_tree=cn_tree,
        cond=rng.random((1, H, W, 3)).astype(np.float32),
        kps=rng.random((1, H, W, 3)).astype(np.float32))


def _inputs(setup, pkg, ip: bool):
    """(base inputs, two concepts' inputs) of one package."""
    tids = (jsdxl if pkg == "jax" else sdxl).add_time_ids((H, W), (0, 0),
                                                          (H, W))
    arr = jnp.asarray if pkg == "jax" else t
    mod = jmc if pkg == "jax" else mc
    base = mod.make_base_inputs(*map(arr, setup["arrays"]), tids, 7.5)
    concepts = [mod.make_concept_inputs(
        *map(arr, setup["concept"]), tids,
        ip_context=arr(setup["ip_tokens"][k]) if ip else None)
        for k in range(2)]
    return base, concepts


def _case_kwargs(setup, case, pkg):
    """``sample_stage``'s conditioning keywords of one case."""
    jax_side = pkg == "jax"
    arr = jnp.asarray if jax_side else t
    kw = {}
    if case == "lora":
        kw["concept_loras"] = (
            [to_jax(x) for x in setup["loras"]] if jax_side else
            [from_jax.lora_from_jax(x, device="cpu") for x in setup["loras"]])
    if case in ("cn_guess", "cn_window"):
        cn = (to_jax(setup["cn_tree"]) if jax_side else
              from_jax.controlnet_from_jax(setup["cn_tree"],
                                           config.tiny_controlnet(),
                                           device="cpu"))
        extra = (dict(guess_mode=True) if case == "cn_guess" else
                 dict(guidance_start=0.25, guidance_end=0.75))
        mod = jmc if jax_side else mc
        scale = jnp.float32(0.9) if jax_side else 0.9
        kw["base_controlnets"] = [mod.ControlNetInputs(
            cn, arr(setup["cond"]), scale, **extra)]
    if case == "instantid":
        kw["concept_ip_adapters"] = [
            to_jax(setup["ip_tree"]) if jax_side else
            from_jax.ip_layers_from_jax(setup["ip_tree"], config.tiny_unet(),
                                        device="cpu")] * 2
        kw["ip_scale"] = 0.8
        cn = (to_jax(setup["cn_tree"]) if jax_side else
              from_jax.controlnet_from_jax(setup["cn_tree"],
                                           config.tiny_controlnet(),
                                           device="cpu"))
        mod = jmc if jax_side else mc
        scale = jnp.float32(0.8) if jax_side else 0.8
        kw["concept_controlnets"] = [mod.ControlNetInputs(
            cn, arr(setup["kps"]), scale,
            encoder_hidden_states=arr(setup["ip_tokens"][k]))
            for k in range(2)]
    if jax_side and case in ("cn_guess", "cn_window", "instantid"):
        kw["cn_cfg"] = jconfig.tiny_controlnet()
    return kw


CASES = ["p2p", "lora", "cn_guess", "cn_window", "instantid", "lcm"]


@pytest.mark.parametrize("case", CASES)
def test_sample_stage_matches_jax(setup, monkeypatch, case):
    """Both stages of the 4-row program, each package from the same noise
    (JAX's ``PRNGKey`` draw handed to the port), at 5e-4."""
    kind = "lcm" if case == "lcm" else "euler"
    key = jax.random.PRNGKey(SEED)
    noise = np.asarray(jax.random.normal(key, (1, H // 8, W // 8, 4)))
    if kind == "lcm":
        nkey = jax.random.fold_in(key, 777)
        monkeypatch.setattr(
            schedulers, "step_noise",
            lambda seed, i, shape, device: t(jax.random.normal(
                jax.random.fold_in(nkey, i), shape, jnp.float32)))
    ip = case == "instantid"
    jbase, jconcepts = _inputs(setup, "jax", ip)
    tbase, tconcepts = _inputs(setup, "torch", ip)
    ctl_kw = dict(self_replace_steps=0.4, width=1, height=1)
    common = dict(height=H, width=W, stage=1, fusion_start=FUSION)
    jkw = dict(common, key=key, base_inputs=jbase,
               controller=jp2p.P2PControl.build(["a", "a"], STEPS, **ctl_kw),
               concept_inputs=jconcepts, concept_loras=[None, None],
               masks=jnp.asarray(setup["masks"]))
    jkw.update(_case_kwargs(setup, case, "jax"))
    tkw = dict(common, initial_noise=noise, noise_seed=SEED,
               base_inputs=tbase,
               controller=p2p.P2PControl.build(["a", "a"], STEPS, **ctl_kw),
               concept_inputs=tconcepts, concept_loras=[None, None],
               masks=t(setup["masks"]))
    tkw.update(_case_kwargs(setup, case, "torch"))
    jcfg, tcfg = jsdxl.tiny_config(), sdxl.tiny_config()
    jsch = jsched.make_schedule(kind, STEPS)
    tsch = schedulers.make_schedule(kind, STEPS)
    for stage in (1, 2):
        want = jmc.sample_stage(jcfg, jsch, setup["jp"].unet,
                                **dict(jkw, stage=stage))
        with torch.no_grad():
            got = mc.sample_stage(tcfg, tsch, setup["tp"].unet,
                                  **dict(tkw, stage=stage))
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=LATENT_ATOL,
                                   err_msg=f"{case} stage {stage}")
        if stage == 1:
            # the premise of the dedup fast path: both copies stay equal
            np.testing.assert_array_equal(got[0].numpy(), got[1].numpy())
        else:
            # fusion moved copy B only
            assert not np.allclose(got[1].numpy(), stage1[1].numpy(),
                                   atol=1e-4), case
            np.testing.assert_allclose(got[0].numpy(), stage1[0].numpy(),
                                       atol=1e-5)
        stage1 = got


@pytest.mark.parametrize("case", ["lora", "cn_guess", "instantid", "lcm"])
def test_fast_paths_match_sample_stage(setup, case):
    """The port's dedup stage 1 and its resumed stage 2 (the 3+2K
    trajectory program and the 4+2K program) equal its 4-row
    ``sample_stage`` (tests/test_multiconcept.py's identities)."""
    kind = "lcm" if case == "lcm" else "euler"
    sch = schedulers.make_schedule(kind, STEPS)
    ip = case == "instantid"
    base, concepts = _inputs(setup, "torch", ip)
    kw = _case_kwargs(setup, case, "torch")
    loras = kw.pop("concept_loras", [None, None])
    ctl = p2p.P2PControl.build(["a", "a"], STEPS, self_replace_steps=0.4,
                               width=1, height=1)
    cfg, unet = sdxl.tiny_config(), setup["tp"].unet
    masks = t(setup["masks"])
    with torch.no_grad():
        slow = [mc.sample_stage(
            cfg, sch, unet, height=H, width=W, base_inputs=base,
            controller=ctl, concept_inputs=concepts, concept_loras=loras,
            masks=masks, stage=stage, fusion_start=FUSION,
            initial_noise=setup["noise"], noise_seed=SEED, **kw)
            for stage in (1, 2)]
        s1, cache = mc.sample_stage1_cached(
            cfg, sch, unet, generator=None, height=H, width=W,
            base_inputs=base, fusion_start=FUSION,
            base_controlnets=kw.get("base_controlnets", ()),
            initial_noise=setup["noise"], noise_seed=SEED)
        stage2_kw = dict(base_inputs=base, controller=ctl,
                         concept_inputs=concepts, concept_loras=loras,
                         masks=masks, fusion_start=FUSION, **kw)
        fast = mc.sample_stage2_resumed(cfg, sch, unet, cache, **stage2_kw)
        four = mc.sample_stage2_resumed(
            cfg, sch, unet, cache._replace(a_traj=None), **stage2_kw)
    np.testing.assert_allclose(s1.numpy(), slow[0].numpy(), atol=2e-4)
    for name, got in (("3+2K", fast), ("4+2K", four)):
        np.testing.assert_allclose(got.numpy(), slow[1].numpy(), atol=2e-4,
                                   err_msg=name)


def test_zero_concept_stage2_is_the_four_row_step(setup):
    """With no concept the 4+2K program runs ``multiconcept_step``'s loop:
    stage 2 then equals stage 1 of the 4-row program, copy for copy."""
    base, _ = _inputs(setup, "torch", False)
    sch = schedulers.make_schedule("euler", STEPS)
    cfg, unet = sdxl.tiny_config(), setup["tp"].unet
    ctl = p2p.P2PControl.build(["a", "a"], STEPS, self_replace_steps=0.4,
                               width=1, height=1)
    calls = []
    step = mc.multiconcept_step

    def counting(*a, **k):
        calls.append(a[5])
        return step(*a, **k)
    with torch.no_grad():
        slow = mc.sample_stage(cfg, sch, unet, height=H, width=W,
                               base_inputs=base, controller=ctl, stage=1,
                               fusion_start=FUSION,
                               initial_noise=setup["noise"])
        _, cache = mc.sample_stage1_cached(
            cfg, sch, unet, generator=None, height=H, width=W,
            base_inputs=base, fusion_start=FUSION,
            initial_noise=setup["noise"])
        mc.multiconcept_step, saved = counting, mc.multiconcept_step
        try:
            got = mc.sample_stage2_resumed(
                cfg, sch, unet, cache._replace(a_traj=None),
                base_inputs=base, controller=ctl, concept_inputs=[],
                concept_loras=[], masks=torch.zeros((0, 4, 4)),
                fusion_start=FUSION)
        finally:
            mc.multiconcept_step = saved
    assert calls == list(range(FUSION + 1, STEPS))
    np.testing.assert_allclose(got.numpy(), slow.numpy(), atol=2e-4)
