"""One seed, one noise, on every device: the initial latents
(``sdxl.prepare_latents``) and LCM's re-noise (``schedulers.step_noise``)
are drawn by a CPU generator and moved to the device, as the JAX
package's counter-based draws are the same bits on every backend. This
file imports no jax, so on the GPU machine it runs alone:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/port/test_torch_seeded_draws.py
"""

import hashlib

import pytest
import torch

from omg_tpu_torch.diffusion import schedulers
from omg_tpu_torch.pipelines import sdxl


def _latents(seed, device):
    sched = schedulers.make_schedule("euler", 10)
    return sdxl.prepare_latents(torch.Generator("cpu").manual_seed(seed), 1,
                                64, 48, sched, torch.float32, device)


@pytest.mark.parametrize("seed", [0, 14])
def test_draws_come_from_a_cpu_generator(seed):
    sched = schedulers.make_schedule("euler", 10)
    unit = torch.randn((1, 8, 6, 4),
                       generator=torch.Generator("cpu").manual_seed(seed))
    torch.testing.assert_close(_latents(seed, "cpu"),
                               schedulers.scale_initial_noise(sched, unit),
                               rtol=0, atol=0)
    digest = hashlib.blake2b(f"{seed}/{schedulers.NOISE_SALT}/3".encode(),
                             digest_size=8).digest()
    g = torch.Generator("cpu").manual_seed(
        int.from_bytes(digest, "little") & (2 ** 63 - 1))
    assert torch.equal(schedulers.step_noise(seed, 3, (1, 8, 6, 4), "cpu"),
                       torch.randn((1, 8, 6, 4), generator=g))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device to compare its draws with the CPU's")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [0, 14])
def test_cpu_and_card_draw_the_same(cuda, seed):
    assert torch.equal(_latents(seed, cuda).cpu(), _latents(seed, "cpu"))
    for i in (0, 3):
        assert torch.equal(
            schedulers.step_noise(seed, i, (1, 128, 128, 4), cuda).cpu(),
            schedulers.step_noise(seed, i, (1, 128, 128, 4), "cpu"))
