"""Model FLOPs of InstantID's three parts, counted as ``flops.py`` counts:
products only, a multiply-add as two.

``identitynet_forward``: one lane of the IdentityNet (a ControlNet: the
UNet's encoder and mid block over the face tokens, the conditioning
embedder at pixel resolution, the zero convs). ``ip_branch``: the
decoupled IP cross-attention a UNet forward adds to one lane (each
attn2's ``to_k_ip``/``to_v_ip`` over the tokens, and its attention over
them). ``resampler``: the Perceiver resampler on one embedding.
"""

from __future__ import annotations

from benchmark import flops as fl
from benchmark.weights import attention_depths
from benchmark.weights_instantid import attn2_paths, skip_channels


def identitynet_forward(cn: dict, h: int, w: int, ctx_len: int = 16) -> int:
    """One lane at latent h x w, its cross-attention over ``ctx_len``
    tokens."""
    chs, depths = list(cn["block_out_channels"]), attention_depths(cn)
    lpb, ctx_dim, temb = cn["layers_per_block"], cn["cross_attention_dim"], \
        4 * chs[0]
    f = fl.linear(1, chs[0], temb) + fl.linear(1, temb, temb)
    f += fl.linear(1, cn["projection_class_embeddings_input_dim"], temb)
    f += fl.linear(1, temb, temb)
    # the conditioning embedder: 3x3 convs at pixel resolution, three
    # stride-2 steps down to the latent's
    emb = list(cn["conditioning_embedding_out_channels"])
    hw = 64 * h * w
    f += fl.conv(emb[0], cn["conditioning_channels"], 3, hw)
    for a, b in zip(emb[:-1], emb[1:]):
        f += fl.conv(a, a, 3, hw)
        hw //= 4
        f += fl.conv(b, a, 3, hw)
    hw = h * w
    f += fl.conv(chs[0], emb[-1], 3, hw)
    f += fl.conv(chs[0], cn["in_channels"], 3, hw)
    cin = chs[0]
    for i, c in enumerate(chs):
        for _ in range(lpb):
            f += fl._resnet(cin, c, hw, temb)
            cin = c
            if depths[i]:
                f += fl._transformer(c, depths[i], hw, ctx_len, ctx_dim, 0)
        if i < len(chs) - 1:
            hw //= 4
            f += fl.conv(c, c, 3, hw)
    f += 2 * fl._resnet(chs[-1], chs[-1], hw, temb)
    f += fl._transformer(chs[-1], depths[-1], hw, ctx_len, ctx_dim, 0)
    # the zero convs, each at its skip's resolution
    hw = h * w
    sizes = [hw]
    for i, c in enumerate(chs):
        sizes += [hw] * lpb
        if i < len(chs) - 1:
            hw //= 4
            sizes.append(hw)
    f += sum(fl.conv(c, c, 1, n) for c, n in zip(skip_channels(cn), sizes))
    return f + fl.conv(chs[-1], chs[-1], 1, hw)


def ip_branch(u: dict, h: int, w: int, tokens: int = 16) -> int:
    """What the IP branch adds to one lane of one UNet forward (each
    level's width is its own, so a width names its resolution)."""
    chs, ctx_dim = list(u["block_out_channels"]), u["cross_attention_dim"]
    f = 0
    for _, c in attn2_paths(u):
        n = h * w // 4 ** chs.index(c)
        f += 2 * fl.linear(tokens, ctx_dim, c) + fl.attention(n, tokens, c)
    return f


def resampler(r: dict, embeds: int = 1) -> int:
    """One embedding row through the resampler."""
    dim, inner, q = r["dim"], r["dim_head"] * r["heads"], r["num_queries"]
    f = fl.linear(embeds, r["embedding_dim"], dim)
    layer = (fl.linear(q, dim, inner) + fl.linear(embeds + q, dim, 2 * inner)
             + fl.attention(q, embeds + q, inner) + fl.linear(q, inner, dim)
             + fl.linear(q, dim, dim * r["ff_mult"])
             + fl.linear(q, dim * r["ff_mult"], dim))
    return f + r["depth"] * layer + fl.linear(q, dim, r["output_dim"])
