"""What an adapted projection costs the host: the operators a tiny UNet
forward runs with prepared LoRA factors, against the same forward
without LoRA (``TorchDispatchMode``, on the CPU).

Each adapted projection group (a fused q/k/v or k/v product, or a lone
``Linear``) adds exactly two matmul-class operators: ``x @ down`` and the
up GEMM that accumulates into the product. No adapter factor is cast or
copied, and no multiply or add runs over the activation for the LoRA or
the bias. The factors' first use builds the fused groups, so the count
is taken on a second forward."""

import collections

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from omg_tpu_torch import config
from omg_tpu_torch import lora as lora_lib
from omg_tpu_torch.models import unet as unet_lib
from omg_tpu_torch.nn import attention, layers

MATMULS = {"matmul", "mm", "addmm", "addmm_", "bmm", "baddbmm", "baddbmm_"}
# operators that make views or read metadata: no launch on a card
VIEWS = {"view", "_unsafe_view", "reshape", "t", "transpose", "expand",
         "slice", "as_strided", "alias", "detach", "unsqueeze", "squeeze",
         "permute", "split", "chunk", "unflatten", "select", "sym_size",
         "sym_stride", "sym_numel", "sym_storage_offset", "is_same_size",
         "split_with_sizes"}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class Ops(TorchDispatchMode):
    """The name of every operator dispatched, in order."""

    def __init__(self):
        super().__init__()
        self.names = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.names.append(func.overloadpacket.__name__)
        return func(*args, **(kwargs or {}))


def adapter(unet, seed: int) -> dict:
    """A rank-2 adapter on every attention projection."""
    g = torch.Generator().manual_seed(seed)
    out = {}
    for name, m in unet.named_modules():
        if isinstance(m, layers.Linear) and ".attn" in name:
            n_out, n_in = m.weight.shape
            out[name] = {"down": 0.1 * torch.randn(n_in, 2, generator=g),
                         "up": 0.1 * torch.randn(2, n_out, generator=g),
                         "scale": torch.tensor(0.8)}
    return out


def compute(names) -> collections.Counter:
    return collections.Counter(n for n in names if n not in VIEWS)


@pytest.mark.parametrize("form", ["shared", "lanes"])
def test_an_adapted_group_adds_two_gemms(form):
    cfg = config.tiny_unet()
    unet = unet_lib.init_params(torch.Generator().manual_seed(0), cfg)
    a, b = adapter(unet, 1), adapter(unet, 2)
    lanes = 3
    if form == "shared":
        lora = lora_lib.prepare(a, cfg.dtype)
    else:
        lora = lora_lib.stack_loras([None, a, b], dtype=cfg.dtype)
    g = torch.Generator().manual_seed(3)
    s = cfg.sample_size
    args = (torch.randn(lanes, s, s, 4, generator=g), 501,
            torch.randn(lanes, 77, cfg.cross_attention_dim, generator=g))
    kw = dict(text_embeds=torch.randn(lanes, 16, generator=g),
              time_ids=torch.full((lanes, 6), float(s * 8)))
    blocks = [m for m in unet.modules() if isinstance(m, attention.Attention)]
    # per block: attn1's q/k/v and to_out, attn2's to_q, k/v and to_out
    groups = 5 * len(blocks) // 2
    assert groups > 0 and len(a) == 8 * len(blocks) // 2
    with torch.inference_mode():
        unet(*args, lora=lora, **kw)            # builds the fused groups
        with Ops() as plain:
            want = unet(*args, **kw)
        with Ops() as adapted:
            got = unet(*args, lora=lora, **kw)
    extra = compute(adapted.names)
    extra.subtract(compute(plain.names))
    extra = {k: v for k, v in extra.items() if v}
    assert set(extra) <= MATMULS
    assert sum(extra.values()) == 2 * groups
    # the up GEMM accumulates into the product, in place
    assert extra["addmm_" if form == "shared" else "baddbmm_"] == groups
    assert not torch.equal(got, want)
    if form == "lanes":
        # the zero-pad lane carries no delta
        assert torch.equal(got[0], want[0])
