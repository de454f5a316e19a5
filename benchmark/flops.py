"""The yardstick's arithmetic: peaks, model FLOPs counted from shapes, and
the flash-attention kernel's roofline bound.

FLOPs count multiply-adds as two and only the products (convolutions,
linears, attention's QK^T and PV, LoRA factors); norms and elementwise work
are left out, as model-FLOPs utilisation counts them.
"""

from __future__ import annotations

from benchmark.weights import attention_depths

# NVIDIA H100 SXM data sheet, dense, at the full 700 W limit
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12
K1_MIN_TOKENS = 1024            # the port's gate: round_up(N, 128) >= 1024
K1_HEAD_DIMS = (64, 128)


def conv(cout: int, cin: int, k: int, hw: int) -> int:
    return 2 * cout * cin * k * k * hw


def linear(n: int, cin: int, cout: int) -> int:
    return 2 * n * cin * cout


def attention(nq: int, nk: int, c: int) -> int:
    """QK^T and PV over all heads of width c."""
    return 4 * nq * nk * c


def _resnet(cin: int, cout: int, hw: int, temb: int) -> int:
    f = conv(cout, cin, 3, hw) + conv(cout, cout, 3, hw)
    f += linear(1, temb, cout) if temb else 0
    return f + (conv(cout, cin, 1, hw) if cin != cout else 0)


def _transformer(c: int, depth: int, n: int, ctx_len: int, ctx_dim: int,
                 lora_rank: int) -> int:
    block = (4 * linear(n, c, c) + attention(n, n, c)                 # attn1
             + 2 * linear(n, c, c) + 2 * linear(ctx_len, ctx_dim, c)  # attn2
             + attention(n, ctx_len, c)
             + linear(n, c, 8 * c) + linear(n, 4 * c, c))              # ff
    if lora_rank:
        r = lora_rank
        block += 6 * (linear(n, c, r) + linear(n, r, c))    # q, k, v, out; q, out
        block += 2 * (linear(ctx_len, ctx_dim, r) + linear(ctx_len, r, c))
    return 2 * linear(n, c, c) + depth * block


def unet_forward(u: dict, h: int, w: int, *, ctx_len: int = 77,
                 lora_rank: int = 0) -> int:
    """One lane of one UNet forward at latent h x w."""
    chs, depths = list(u["block_out_channels"]), attention_depths(u)
    lpb, ctx_dim, temb = u["layers_per_block"], u["cross_attention_dim"], \
        4 * chs[0]
    f = linear(1, chs[0], temb) + linear(1, temb, temb)
    f += linear(1, u["projection_class_embeddings_input_dim"], temb)
    f += linear(1, temb, temb)
    hw = h * w
    f += conv(chs[0], u["in_channels"], 3, hw)
    cin = chs[0]
    for i, c in enumerate(chs):
        for _ in range(lpb):
            f += _resnet(cin, c, hw, temb)
            cin = c
            if depths[i]:
                f += _transformer(c, depths[i], hw, ctx_len, ctx_dim,
                                  lora_rank)
        if i < len(chs) - 1:
            hw //= 4
            f += conv(c, c, 3, hw)
    f += 2 * _resnet(chs[-1], chs[-1], hw, temb)
    f += _transformer(chs[-1], depths[-1], hw, ctx_len, ctx_dim, lora_rank)
    rev, rdepths = chs[::-1], depths[::-1]
    prev = rev[0]
    for i, c in enumerate(rev):
        skip_in = rev[min(i + 1, len(rev) - 1)]
        for j in range(lpb + 1):
            res_in = prev if j == 0 else c
            skip = skip_in if j == lpb else c
            f += _resnet(res_in + skip, c, hw, temb)
            if rdepths[i]:
                f += _transformer(c, rdepths[i], hw, ctx_len, ctx_dim,
                                  lora_rank)
        if i < len(rev) - 1:
            hw *= 4
            f += conv(c, c, 3, hw)
        prev = c
    return f + conv(u["out_channels"], chs[0], 3, hw)


def vae_decode(v: dict, h: int, w: int) -> int:
    """One image decoded from latent h x w."""
    chs, lpb, lat = list(v["block_out_channels"]), v["layers_per_block"], \
        v["latent_channels"]
    hw = h * w
    f = conv(lat, lat, 1, hw) + conv(chs[-1], lat, 3, hw)
    mid = 2 * _resnet(chs[-1], chs[-1], hw, 0)
    mid += 4 * linear(hw, chs[-1], chs[-1]) + attention(hw, hw, chs[-1])
    f += mid
    rev = chs[::-1]
    prev = rev[0]
    for i, c in enumerate(rev):
        for j in range(lpb + 1):
            f += _resnet(prev if j == 0 else c, c, hw, 0)
        if i < len(rev) - 1:
            hw *= 4
            f += conv(c, c, 3, hw)
        prev = c
    return f + conv(v["out_channels"], chs[0], 3, hw)


def clip_encode(t: dict, n: int = 77) -> int:
    """One prompt through one text encoder."""
    d, inner = t["hidden_size"], t["intermediate_size"]
    layer = 4 * linear(n, d, d) + attention(n, n, d) + \
        linear(n, d, inner) + linear(n, inner, d)
    f = t["num_hidden_layers"] * layer
    if "CLIPTextModelWithProjection" in t["architectures"]:
        f += linear(1, d, t["projection_dim"])
    return f


def prompt_encode(cfg: dict) -> int:
    """One prompt through both SDXL text encoders."""
    return clip_encode(cfg["text_encoder"]) + clip_encode(cfg["text_encoder_2"])


def k1_calls(u: dict, lanes: int, h: int, w: int) -> list:
    """(B, heads, N, D) of each flash-attention self-attention of one UNet
    forward over ``lanes`` lanes at latent h x w (the port's gate: every
    self-attention of at least 1024 tokens with a head width of 64 or
    128)."""
    chs, depths = list(u["block_out_channels"]), attention_depths(u)
    hd = chs[0] // u["attention_head_dim"][0]
    lpb = u["layers_per_block"]
    out = []
    n = h * w
    for i, c in enumerate(chs):
        blocks = depths[i] * (lpb + (lpb + 1))      # down and up
        if i == len(chs) - 1:
            blocks += depths[i]                     # mid
        if blocks and -(-n // 128) * 128 >= K1_MIN_TOKENS and \
                hd in K1_HEAD_DIMS:
            out += [(lanes, c // hd, n, hd)] * blocks
        n //= 4
    return out


def k1_bound_s(b: int, h: int, n: int, d: int, elem: int = 2) -> float:
    """The least time of one K1 call: the larger of 4 B H N^2 D FLOPs at
    the bf16 peak and q, k, v, o each moved once at the memory rate
    (``chip_smoke.roofline``, frozen)."""
    flops = 4 * b * h * n * n * d
    nbytes = elem * b * h * d * 4 * n
    return max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES_PER_S)
