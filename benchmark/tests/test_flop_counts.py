"""The FLOP and roofline arithmetic against hand counts."""

import json
import pathlib

import pytest

from benchmark import flops

CONFIGS = pathlib.Path(__file__).resolve().parents[1] / "configs"


def tiny_unet():
    # one plain level of 8 channels, one cross-attention level of 16
    # channels (heads of 8), one resnet a level
    return {"in_channels": 4, "out_channels": 4, "block_out_channels": [8, 16],
            "down_block_types": ["DownBlock2D", "CrossAttnDownBlock2D"],
            "transformer_layers_per_block": [1, 1], "layers_per_block": 1,
            "attention_head_dim": [1, 2], "cross_attention_dim": 12,
            "projection_class_embeddings_input_dim": 20}


def hand_unet(h, w, r=0):
    hw, q = h * w, h * w // 4
    temb = 32
    conv = lambda co, ci, k, n: 2 * co * ci * k * k * n  # noqa: E731
    lin = lambda n, ci, co: 2 * n * ci * co  # noqa: E731

    def res(ci, co, n):
        return (conv(co, ci, 3, n) + conv(co, co, 3, n) + lin(1, temb, co)
                + (conv(co, ci, 1, n) if ci != co else 0))

    def tr(c, n):
        blk = (4 * lin(n, c, c) + 4 * n * n * c + 2 * lin(n, c, c)
               + 2 * lin(77, 12, c) + 4 * n * 77 * c
               + lin(n, c, 8 * c) + lin(n, 4 * c, c))
        if r:
            blk += 6 * (lin(n, c, r) + lin(n, r, c)) + \
                2 * (lin(77, 12, r) + lin(77, r, c))
        return 2 * lin(n, c, c) + blk

    f = lin(1, 8, temb) + 2 * lin(1, temb, temb) + lin(1, 20, temb)
    f += conv(8, 4, 3, hw)
    f += res(8, 8, hw) + conv(8, 8, 3, q)                     # level 0
    f += res(8, 16, q) + tr(16, q)                            # level 1
    f += 2 * res(16, 16, q) + tr(16, q)                       # mid
    # up level 0 (16 ch at q): skips [16 (l1), 8 (down), ...]
    f += res(16 + 16, 16, q) + tr(16, q) + res(16 + 8, 16, q) + tr(16, q)
    f += conv(16, 16, 3, hw)                                  # upsample
    f += res(16 + 8, 8, hw) + res(8 + 8, 8, hw)               # up level 1
    return f + conv(4, 8, 3, hw)


@pytest.mark.parametrize("rank", [0, 2])
def test_unet_forward_matches_a_hand_count(rank):
    assert flops.unet_forward(tiny_unet(), 4, 6, lora_rank=rank) == \
        hand_unet(4, 6, rank)


def test_vae_decode_matches_a_hand_count():
    v = {"block_out_channels": [4, 8], "layers_per_block": 1,
         "latent_channels": 4, "out_channels": 3}
    conv = lambda co, ci, k, n: 2 * co * ci * k * k * n  # noqa: E731
    hw = 9
    res = lambda ci, co, n: conv(co, ci, 3, n) + conv(co, co, 3, n) + (  # noqa: E731
        conv(co, ci, 1, n) if ci != co else 0)
    want = conv(4, 4, 1, hw) + conv(8, 4, 3, hw)
    want += 2 * res(8, 8, hw) + 4 * 2 * hw * 8 * 8 + 4 * hw * hw * 8
    want += 2 * res(8, 8, hw) + conv(8, 8, 3, 4 * hw)         # up level 0
    want += res(8, 4, 4 * hw) + res(4, 4, 4 * hw)             # up level 1
    want += conv(3, 4, 3, 4 * hw)
    assert flops.vae_decode(v, 3, 3) == want


def test_clip_encode_matches_a_hand_count():
    t = {"hidden_size": 4, "intermediate_size": 8, "num_hidden_layers": 2,
         "architectures": ["CLIPTextModelWithProjection"], "projection_dim": 3}
    layer = 4 * 2 * 77 * 16 + 4 * 77 * 77 * 4 + 2 * 2 * 77 * 32
    assert flops.clip_encode(t) == 2 * layer + 2 * 4 * 3


def test_k1_calls_at_sdxl_1024():
    cfg = json.loads((CONFIGS / "omg_lora2_sdxl.json").read_text())
    calls = flops.k1_calls(cfg["unet"], 7, 128, 128)
    # 4096 tokens: 2 x 2 down + 3 x 2 up blocks; 1024 tokens: 2 x 10 down,
    # 10 mid, 3 x 10 up (the launch counts PERF.md's kernel table lists)
    assert calls.count((7, 10, 4096, 64)) == 10
    assert calls.count((7, 20, 1024, 64)) == 60
    assert len(calls) == 70


def test_k1_bound_is_the_larger_of_flops_and_bytes():
    # [2, 10, 4096, 64]: 4 B H N^2 D = 85.9 GFLOP at 989 TFLOP/s is
    # 0.0869 ms (PERF.md's table), far above its 42 MB at 3.35 TB/s
    assert flops.k1_bound_s(2, 10, 4096, 64) * 1e3 == pytest.approx(
        0.0869, abs=5e-5)
    # a short sequence is bound by its bytes
    b, h, n, d = 1, 1, 16, 64
    assert flops.k1_bound_s(b, h, n, d) == pytest.approx(
        2 * b * h * d * 4 * n / flops.PEAK_BYTES_PER_S)
