"""The slice as a whole: a tiny HF-layout checkout and two kohya LoRA
files, loaded by each package's own loader, tokenizer and LoRA reader,
through ``OMG.generate`` with the same initial noise (latents within
5e-4, uint8 images within one level); then the port's two CLIs run
in-process on the CPU on such files: the JAX CLI's output names and
hash, the stage images equal ``OMG.generate``'s called directly,
``--mesh 2`` on two CPU ranks within a level of one device (and, in a
world too small for it, a SystemExit before any weight loads), and the
DeepCache flags reach the engine."""

import contextlib
import hashlib
import json
import os

import jax.numpy as jnp
import numpy as np
import PIL.Image
import pytest
import torch

from omg_tpu import config as jconfig
from omg_tpu import loader as jloader
from omg_tpu import lora as jlora
from omg_tpu.models import controlnet as jcn
from omg_tpu.pipelines import omg as jomg
from omg_tpu_torch import config, loader, lora
from omg_tpu_torch.cli import inference_instantid, inference_lora
from omg_tpu_torch.models import resampler, unet
from omg_tpu_torch.parallel import comm
from omg_tpu_torch.pipelines import omg
from omg_tpu_torch.segment import build_mask_provider
from omg_tpu_torch.utils import image

from tests.test_convert import _emit_torch_sd
from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse)
from torch_port_helpers import (left_right_masks, normal, numpy_params,
                                record_decodes, unet_config_json,
                                write_lora_checkout, write_safetensors)

PROMPT = "photo of the man and the woman at the beach"
REWRITE = "[photo of the man]-*-[ugly]|[photo of the woman]-*-[blurry]"
LATENT_ATOL = 5e-4


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """The tiny checkout, two kohya LoRA files, a tiny SAM ViT file
    (256-wide embedding, the decoder's), an IdentityNet directory, an
    ``ip-adapter.bin`` and two face PNGs with their sidecars."""
    root = tmp_path_factory.mktemp("files")
    rng = np.random.default_rng(3)
    g = torch.Generator().manual_seed(4)
    ckpt, loras, sam = write_lora_checkout(root, rng, g)
    idnet = root / "idnet"
    os.makedirs(idnet)
    ccfg = jconfig.tiny_controlnet()
    write_safetensors(idnet / "diffusion_pytorch_model.safetensors",
                      _emit_torch_sd(numpy_params(jcn.init_params, ccfg, 5)))
    with open(idnet / "config.json", "w") as f:
        json.dump(unet_config_json(
            ccfg.unet, conditioning_embedding_out_channels=list(
                ccfg.conditioning_embedding_out_channels)), f)
    rs = resampler.init_params(g, config.tiny_resampler())
    ip = unet.init_ip_layers(g, config.tiny_unet())
    adapter = str(root / "ip-adapter.bin")
    torch.save({"image_proj": rs.state_dict(), "ip_adapter": {
        f"{2 * int(k.split('.')[0]) + 1}.{k.split('.', 1)[1]}": v
        for k, v in ip.state_dict().items()}}, adapter)
    faces = []
    for i in range(2):
        face = str(root / f"face{i}.png")
        image.write_png(face, rng.integers(0, 256, (24, 24, 3), np.uint8))
        np.save(face + ".arcface.npy",
                normal(rng, config.tiny_resampler().embedding_dim))
        faces.append(face)
    np.save(faces[0] + ".kps.npy", normal(rng, 5, 2))
    return dict(root=root, ckpt=ckpt, loras=loras, sam=sam,
                idnet=str(idnet), adapter=adapter, faces=faces)


def test_generate_from_files_matches_jax(files, monkeypatch):
    kw = dict(negative_prompt="ugly", prompt_rewrite=REWRITE, seed=5,
              height=64, width=64, num_steps=3,
              initial_noise=normal(np.random.default_rng(6), 1, 8, 8, 4))
    jcfg, jparams, jtok1, jtok2 = jloader.load_sdxl(
        files["ckpt"], dtype=jnp.float32, pack=False)
    jeng = jomg.OMG(cfg=jcfg, params=jparams, tokenizer=jtok1,
                    tokenizer_2=jtok2, mask_provider=left_right_masks,
                    num_steps=3)
    cfg, params, tok1, tok2 = loader.load_sdxl(
        files["ckpt"], dtype=torch.float32, device="cpu")
    teng = omg.OMG(cfg=cfg, params=params, tokenizer=tok1, tokenizer_2=tok2,
                   mask_provider=left_right_masks, num_steps=3)
    want_lat, got_lat = [], []
    record_decodes(monkeypatch, jomg.OMG, want_lat)
    record_decodes(monkeypatch, omg.OMG, got_lat)
    want = jeng.generate(PROMPT, concept_loras=[jlora.load_lora(p)
                                                for p in files["loras"]],
                         **kw)
    got = teng.generate(PROMPT, concept_loras=[
        lora.load_lora(p, device="cpu") for p in files["loras"]], **kw)
    assert len(got_lat) == len(want_lat) == 2           # stage 1, stage 2
    for g, w in zip(got_lat, want_lat):
        np.testing.assert_allclose(g, w, atol=LATENT_ATOL)
    for name in ("stage1", "stage2"):
        g, w = getattr(got, name), getattr(want, name)
        assert g.shape == w.shape == (2, 64, 64, 3)
        assert np.abs(g.astype(int) - w.astype(int)).max() <= 1, name


def _config_hash(model, negative):
    lines = [f"pretrained_model: {model}\n", f"context_prompt: {PROMPT}\n",
             f"neg_context_prompt: {negative}\n",
             f"prompt_rewrite: {REWRITE}\n"]
    return hashlib.sha256("".join(lines).encode()).hexdigest()[:8], lines


def _check_outputs(out_dir, model, negative, result):
    """The JAX CLI's file names, config lines and hash; the PNGs read back
    (port reader and PIL) equal the result's copy-B images."""
    code, lines = _config_hash(model, negative)
    with open(os.path.join(out_dir, f"image---s---{code}.txt")) as f:
        assert f.readlines() == lines
    for name in ("stage1", "stage2"):
        png = os.path.join(out_dir, name.replace("stage", "stage-") + ".png")
        want = getattr(result, name)[1]
        np.testing.assert_array_equal(image.read_png(png), want)
        np.testing.assert_array_equal(np.asarray(PIL.Image.open(png)), want)


def test_inference_lora_cli(files, capsys):
    out = str(files["root"] / "out_lora")
    argv = ["--pretrained_sdxl_model", files["ckpt"],
            "--lora_path", "|".join(files["loras"]), "--prompt", PROMPT,
            "--negative_prompt", "ugly", "--prompt_rewrite", REWRITE,
            "--efficientViT_checkpoint", files["sam"], "--save_dir", out,
            "--seed", "9", "--suffix", "s", "--num_steps", "2",
            "--height", "64", "--width", "64", "--device", "cpu"]
    res = inference_lora.main(argv)
    assert res.stage2 is not None and all(m is not None for m in res.masks)
    _check_outputs(os.path.join(out, "seed_9"), files["ckpt"], "ugly", res)
    # the same run through the API
    cfg, params, tok1, tok2 = loader.load_sdxl(files["ckpt"], device="cpu")
    eng = omg.OMG(cfg=cfg, params=params, tokenizer=tok1, tokenizer_2=tok2,
                  mask_provider=build_mask_provider(
                      "sam", sam_checkpoint=files["sam"], device="cpu"),
                  num_steps=2)
    direct = eng.generate(PROMPT, negative_prompt="ugly",
                          prompt_rewrite=REWRITE, seed=9, height=64,
                          width=64, concept_loras=[
                              lora.load_lora(p, device="cpu")
                              for p in files["loras"]])
    for name in ("stage1", "stage2"):
        np.testing.assert_array_equal(getattr(res, name),
                                      getattr(direct, name))
    assert "save to:" in capsys.readouterr().out


def test_inference_instantid_cli(files, capsys):
    out = str(files["root"] / "out_iid")
    rewrite = (f"[photo of the man]-*-[ugly]-*-[{files['faces'][0]}]|"
               f"[photo of the woman]-*-[blurry]-*-[{files['faces'][1]}]")
    argv = ["--pretrained_model", files["ckpt"],
            "--controlnet_path", files["idnet"],
            "--face_adapter_path", files["adapter"], "--prompt", PROMPT,
            "--negative_prompt", "noisy", "--prompt_rewrite", rewrite,
            "--efficientViT_checkpoint", files["sam"], "--save_dir", out,
            "--seed", "4", "--suffix", "s", "--num_steps", "2",
            "--height", "64", "--width", "64", "--device", "cpu"]
    res = inference_instantid.main(argv)
    assert res.stage2 is not None
    printed = capsys.readouterr().out
    assert "running stage 2 without the IdentityNet condition" in printed
    code = hashlib.sha256("".join([
        f"pretrained_model: {files['ckpt']}\n",
        f"context_prompt: {PROMPT}\n", "neg_context_prompt: noisy\n",
        f"prompt_rewrite: {rewrite}\n"]).encode()).hexdigest()[:8]
    run = os.path.join(out, "seed_4")
    assert sorted(os.listdir(run)) == sorted(
        ["stage-1.png", "stage-2.png", f"image---s---{code}.txt"])
    np.testing.assert_array_equal(
        image.read_png(os.path.join(run, "stage-2.png")), res.stage2[1])
    kps, emb = inference_instantid.get_face_info(files["faces"][0])
    assert kps.shape == (5, 2) and emb.shape == (16,)
    assert not inference_instantid.get_face_info(files["faces"][1])[0].any()
    with pytest.raises(RuntimeError, match="precompute the ArcFace"):
        inference_instantid.get_face_info(str(files["root"] / "none.png"))


def test_inference_lora_cli_mesh(files, tmp_path):
    """``--mesh 2 --device cpu``: two gloo CPU ranks, (data, model) = (2,
    1), with a spatial ControlNet (the tiny IdentityNet directory serves as
    one) and a condition PNG: rank 0's images within one uint8 level of
    ``--mesh 0``'s, and rank 0 wrote them."""
    cond = str(tmp_path / "cond.png")
    image.write_png(cond, np.random.default_rng(8).integers(
        0, 256, (48, 48, 3), np.uint8))
    argv = ["--pretrained_sdxl_model", files["ckpt"],
            "--lora_path", "|".join(files["loras"]), "--prompt", PROMPT,
            "--negative_prompt", "ugly", "--prompt_rewrite", REWRITE,
            "--efficientViT_checkpoint", files["sam"], "--seed", "9",
            "--suffix", "s", "--num_steps", "3", "--height", "64",
            "--width", "64", "--device", "cpu",
            "--controlnet_checkpoint", files["idnet"],
            "--spatial_condition", cond]
    out = {m: str(tmp_path / f"mesh{m}") for m in (0, 2)}
    res = {m: inference_lora.main(argv + ["--save_dir", out[m], "--mesh",
                                          str(m)]) for m in (0, 2)}
    assert res[2].stage2 is not None
    for name in ("stage1", "stage2"):
        g, w = getattr(res[2], name), getattr(res[0], name)
        assert g.shape == w.shape == (2, 64, 64, 3)
        assert np.abs(g.astype(int) - w.astype(int)).max() <= 1, name
    _check_outputs(os.path.join(out[2], "seed_9"), files["ckpt"], "ugly",
                   res[2])


@pytest.mark.parametrize("cli,argv,err", [
    (inference_lora, ["--mesh", "2"], SystemExit),
    (inference_lora, ["--cache_interval", "3"], None),
    (inference_lora, ["--cache_schedule", "front", "--cache_interval", "3"],
     None),
    (inference_lora, ["--dino_checkpoint", "dino.pth"], SystemExit),
    (inference_instantid, ["--cache_interval", "2"], None)])
def test_cli_errors_fire_before_loading(files, tmp_path, monkeypatch, cli,
                                        argv, err):
    """The model paths do not exist: an error about them would mean the
    load began. ``--mesh 2`` (refused here before the mesh CLI was ported)
    inside a running world of one rank is ``make_latency_mesh``'s
    SystemExit. The DeepCache flags (refused here before DeepCache was
    ported) reach the engine: each CLI runs from the tiny files with
    shallow steps."""
    missing = str(tmp_path / "missing")
    flag = ("--pretrained_sdxl_model" if cli is inference_lora
            else "--pretrained_model")
    if err is not None:
        with contextlib.ExitStack() as stack:
            if "--mesh" in argv:
                comm.init(str(tmp_path / "store"), 0, 1, "gloo", 60.0)
                stack.callback(comm.shutdown)
            with pytest.raises(err, match=(
                    "latency mesh needs 2 devices; only 1 visible"
                    if "--mesh" in argv else None)):
                cli.main([flag, missing, "--device", "cpu"] + argv)
        return
    engines = []
    init = omg.OMG.__post_init__
    monkeypatch.setattr(omg.OMG, "__post_init__",
                        lambda self: engines.append(self) or init(self))
    shallow = []
    apply_shallow = unet.UNet2DConditionModel.apply_shallow
    monkeypatch.setattr(unet.UNet2DConditionModel, "apply_shallow",
                        lambda *a, **k: shallow.append(1) or
                        apply_shallow(*a, **k))
    common = ["--prompt", PROMPT, "--efficientViT_checkpoint", files["sam"],
              "--save_dir", str(tmp_path / "out"), "--num_steps", "6",
              "--height", "64", "--width", "64", "--device", "cpu"]
    if cli is inference_lora:
        common += ["--prompt_rewrite", REWRITE,
                   "--lora_path", "|".join(files["loras"])]
    else:
        common += ["--controlnet_path", files["idnet"],
                   "--face_adapter_path", files["adapter"],
                   "--prompt_rewrite",
                   f"[photo of the man]-*-[ugly]-*-[{files['faces'][0]}]|"
                   f"[photo of the woman]-*-[blurry]-*-[{files['faces'][1]}]"]
    res = cli.main([flag, files["ckpt"]] + common + argv)
    assert res.stage2 is not None and shallow
    interval = int(argv[argv.index("--cache_interval") + 1])
    schedule = (argv[argv.index("--cache_schedule") + 1]
                if "--cache_schedule" in argv else "uniform")
    assert (engines[-1].cache_interval, engines[-1].cache_schedule) == \
        (interval, schedule)
