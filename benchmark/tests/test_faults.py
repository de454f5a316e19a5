"""A run with the timed path broken underneath comes out not correct, a
sound run and the control as they should: the tiny cells on the CPU,
through the whole harness but its look for a card."""

import pytest
import torch

from benchmark import run
from benchmark.tests import readings, tiny
from omg_tpu_torch.diffusion import schedulers
from omg_tpu_torch.pipelines import omg, sdxl


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.tree(tmp_path_factory.mktemp("bench"))


def correct(root, cell, seed=5, **kw):
    return run.run_cell(cell, seed, 0.0, False, device=torch.device("cpu"),
                        root=root, **kw)["correct"]


@pytest.mark.parametrize("cell", ["tiny_omg", "tiny_t2i"])
def test_sound_runs_are_correct(root, cell):
    assert correct(root, cell) is True


@pytest.mark.parametrize("cell", ["tiny_omg", "tiny_t2i"])
def test_the_programs_bf16_decode_is_not_correct(root, cell):
    """The program's own bf16 decode switched on."""
    assert correct(root, cell, control="bf16_decode") is False


@pytest.mark.parametrize("cell", ["tiny_omg", "tiny_t2i"])
def test_the_fp8_reference_is_not_correct(root, cell):
    """The reference in the program's place with float8 operands."""
    (line,) = readings.readings(cell, [5], device=torch.device("cpu"),
                                root=root)
    assert line["correct"] is True
    assert line["fp8_reference_correct"] is False
    assert line["fp8_reference"]["eps_gap"] > 1e-2


@pytest.mark.parametrize("cell", ["tiny_omg", "tiny_t2i"])
def test_a_step_that_returns_its_state_unchanged(root, cell, monkeypatch):
    def unchanged(sched, state, eps, i, x, **kw):
        return x, state

    monkeypatch.setattr(schedulers, "step", unchanged)
    assert correct(root, cell) is False


def test_an_image_altered_where_it_is_decoded(root, monkeypatch):
    """Copy B of every decoded pair comes out mirrored."""
    decode = omg.OMG._decode

    def altered(self, latents):
        img = decode(self, latents)
        img[1] = img[1, :, ::-1]
        return img

    monkeypatch.setattr(omg.OMG, "_decode", altered)
    assert correct(root, "tiny_omg") is False


def test_a_stage2_image_altered(root, monkeypatch):
    """Only stage 2's fused copy B is wrong: its latents mirrored before
    the decode (each generate decodes stage 1, then stage 2)."""
    decode = omg.OMG._decode
    calls = []

    def altered(self, latents):
        calls.append(1)
        if len(calls) % 2 == 0:
            latents = latents.clone()
            latents[1] = latents[1].flip(1)
        return decode(self, latents)

    monkeypatch.setattr(omg.OMG, "_decode", altered)
    assert correct(root, "tiny_omg") is False


def test_half_the_batch_left_out(root, monkeypatch):
    denoise = sdxl.denoise

    def half(cfg, sched, unet, latents, inputs, **kw):
        b = latents.shape[0] // 2
        keep = sdxl.DenoiseInputs(
            torch.cat([inputs.prompt_embeds[:b], inputs.prompt_embeds[2 * b:3 * b]]),
            torch.cat([inputs.text_embeds[:b], inputs.text_embeds[2 * b:3 * b]]),
            inputs.time_ids[:2 * b], inputs.guidance_scale)
        out = denoise(cfg, sched, unet, latents[:b], keep, **kw)
        return torch.cat([out, out])

    monkeypatch.setattr(sdxl, "denoise", half)
    assert correct(root, "tiny_t2i") is False


def test_a_batch_image_altered(root, monkeypatch):
    """The last image of the batch comes out mirrored."""
    decode = sdxl.decode_latents

    def altered(cfg, vae_model, latents, **kw):
        img = decode(cfg, vae_model, latents, **kw)
        return torch.cat([img[:-1], img[-1:].flip(2)])

    monkeypatch.setattr(sdxl, "decode_latents", altered)
    assert correct(root, "tiny_t2i") is False
