"""The port's DDIM, DPM++2M and LCM schedules (and Euler under the other
spacings) against the JAX package's: constants, single steps, a
DPM++2M chain, LCM with JAX's own noise injected, add_noise and the
input/noise scalings, all fp32 at 1e-6."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omg_tpu.diffusion import schedulers as jsched
from omg_tpu_torch.diffusion import schedulers

from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse)
from torch_port_helpers import normal, t

TOL = 1e-6
KINDS = ("euler", "ddim", "dpmpp_2m", "lcm")


def _close(got, want, err_msg=""):
    """Within 1e-6 of max |want| (relative, fp32)."""
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=TOL * max(np.abs(want).max(), 1.0),
                               err_msg=err_msg)


def _jax_key_noise(seed, i, shape):
    """JAX's LCM draw at step i: fold_in(fold_in(PRNGKey(seed), 777), i)."""
    key = jax.random.fold_in(jax.random.PRNGKey(seed), 777)
    return np.asarray(jax.random.normal(jax.random.fold_in(key, i), shape,
                                        jnp.float32))


@pytest.mark.parametrize("steps", [4, 25, 50])
@pytest.mark.parametrize("spacing", ["leading", "trailing", "linspace"])
@pytest.mark.parametrize("kind", KINDS)
def test_schedule_constants(kind, spacing, steps):
    want = jsched.make_schedule(kind, steps, timestep_spacing=spacing)
    got = schedulers.make_schedule(kind, steps, timestep_spacing=spacing)
    assert got.kind == kind and got.num_steps == steps
    np.testing.assert_array_equal(got.timesteps.numpy(),
                                  np.asarray(want.timesteps))
    for name in ("sigmas", "alphas_cumprod", "init_noise_sigma"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)),
                                   rtol=TOL, atol=0, err_msg=name)


def test_unknown_kind_and_spacing_raise():
    with pytest.raises(ValueError, match="heun"):
        schedulers.make_schedule("heun", 10)
    with pytest.raises(ValueError, match="karras"):
        schedulers.make_schedule("euler", 10, timestep_spacing="karras")
    with pytest.raises(ValueError, match="origin grid"):
        schedulers.make_schedule("lcm", 60)


@pytest.mark.parametrize("i", [0, 3, 9])
@pytest.mark.parametrize("kind", KINDS)
def test_step_matches_jax(kind, i):
    """One step from a state that has run (DPM++2M's second-order branch
    from step 1 on), LCM with JAX's draw injected."""
    steps = 10
    rng = np.random.default_rng(100 + i)
    x, eps, prev = (normal(rng, 2, 4, 4, 4) for _ in range(3))
    js = jsched.make_schedule(kind, steps)
    ts = schedulers.make_schedule(kind, steps)
    jstate = jsched.init_state(js, x.shape,
                               key=jax.random.fold_in(jax.random.PRNGKey(5),
                                                      777))
    jstate = jstate._replace(prev_model_output=jnp.asarray(prev),
                             step_count=jnp.int32(min(i, 1)))
    want, jnext = jsched.step(js, jstate, jnp.asarray(eps), i, jnp.asarray(x),
                              shared_batch_noise=True)
    state = schedulers.SchedulerState(min(i, 1), prev_model_output=t(prev))
    noise = t(_jax_key_noise(5, i, (1, 4, 4, 4)))
    got, nxt = schedulers.step(ts, state, t(eps), i, t(x), noise=noise,
                               shared_batch_noise=True)
    _close(got.numpy(), want, kind)
    assert nxt.step_count == state.step_count + 1
    if kind == "dpmpp_2m":
        _close(nxt.prev_model_output.numpy(), jnext.prev_model_output)


def test_dpmpp_2m_chain():
    """Ten DPM++2M steps carrying the previous x0, eps a fixed function of
    the sample."""
    steps = 10
    rng = np.random.default_rng(7)
    w = normal(rng, 4, 4, scale=0.3)
    x0 = normal(rng, 1, 8, 8, 4)
    js = jsched.make_schedule("dpmpp_2m", steps)
    ts = schedulers.make_schedule("dpmpp_2m", steps)
    jx, jst = jsched.scale_initial_noise(js, jnp.asarray(x0)), \
        jsched.init_state(js, x0.shape)
    x, st = schedulers.scale_initial_noise(ts, t(x0)), schedulers.init_state()
    for i in range(steps):
        jeps = jnp.tanh(jsched.scale_model_input(js, jx, i) @ jnp.asarray(w))
        jx, jst = jsched.step(js, jst, jeps, i, jx)
        eps = torch.tanh(schedulers.scale_model_input(ts, x, i) @ t(w))
        x, st = schedulers.step(ts, st, eps, i, x)
        _close(x.numpy(), jx, f"step {i}")
    assert st.step_count == steps


def test_lcm_chain_with_jax_noise():
    """Four LCM steps on two latent copies, each step re-noised with JAX's
    own fold_in draw (one sample broadcast over the copies)."""
    steps, seed = 4, 11
    rng = np.random.default_rng(8)
    w = normal(rng, 4, 4, scale=0.3)
    x0 = np.repeat(normal(rng, 1, 8, 8, 4), 2, axis=0)
    js = jsched.make_schedule("lcm", steps)
    ts = schedulers.make_schedule("lcm", steps)
    jx = jnp.asarray(x0)
    jst = jsched.init_state(js, x0.shape, key=jax.random.fold_in(
        jax.random.PRNGKey(seed), 777))
    x, st = t(x0), schedulers.init_state()
    for i in range(steps):
        jx, jst = jsched.step(js, jst, jnp.tanh(jx @ jnp.asarray(w)), i, jx,
                              shared_batch_noise=True)
        noise = t(_jax_key_noise(seed, i, (1, 8, 8, 4)))
        x, st = schedulers.step(ts, st, torch.tanh(x @ t(w)), i, x,
                                noise=noise, shared_batch_noise=True)
        _close(x.numpy(), jx, f"step {i}")
    assert torch.equal(x[0], x[1])


def test_lcm_noise_is_a_function_of_seed_and_step():
    """The seeded draw depends on (seed, step) only: two states with the
    same seed step alike whatever ran before, other steps or seeds draw
    other noise, and shared noise keeps the copies equal."""
    ts = schedulers.make_schedule("lcm", 4)
    x = torch.randn(2, 4, 4, 4)
    eps = torch.randn(2, 4, 4, 4)
    a, _ = schedulers.step(ts, schedulers.init_state(3), eps, 1, x,
                           shared_batch_noise=True)
    torch.randn(100)          # the global stream plays no part
    b, _ = schedulers.step(ts, schedulers.SchedulerState(
        7, noise_seed=3), eps, 1, x, shared_batch_noise=True)
    assert torch.equal(a, b)
    n1 = schedulers.step_noise(3, 1, (1, 4, 4, 4), torch.device("cpu"))
    assert not torch.equal(n1, schedulers.step_noise(3, 2, (1, 4, 4, 4),
                                                     torch.device("cpu")))
    assert not torch.equal(n1, schedulers.step_noise(4, 1, (1, 4, 4, 4),
                                                     torch.device("cpu")))
    same = torch.randn(1, 4, 4, 4).expand(2, 4, 4, 4)
    c, _ = schedulers.step(ts, schedulers.init_state(3), eps[:1].expand(2, -1,
                           -1, -1), 0, same, shared_batch_noise=True)
    assert torch.equal(c[0], c[1])
    with pytest.raises(ValueError, match="noise_seed"):
        schedulers.step(ts, schedulers.init_state(), eps, 0, x)
    # the last step returns the blend and draws nothing
    last, _ = schedulers.step(ts, schedulers.init_state(), eps, 3, x)
    assert torch.isfinite(last).all()


@pytest.mark.parametrize("kind", KINDS)
def test_add_noise_and_scalings(kind):
    rng = np.random.default_rng(9)
    x0, noise = normal(rng, 2, 4, 4, 4), normal(rng, 2, 4, 4, 4)
    js = jsched.make_schedule(kind, 8)
    ts = schedulers.make_schedule(kind, 8)
    for i in (0, 5):
        _close(schedulers.add_noise(ts, t(x0), t(noise), i).numpy(),
               jsched.add_noise(js, jnp.asarray(x0), jnp.asarray(noise), i))
        _close(schedulers.scale_model_input(ts, t(x0), i).numpy(),
               jsched.scale_model_input(js, jnp.asarray(x0), i))
    _close(schedulers.scale_initial_noise(ts, t(noise)).numpy(),
           jsched.scale_initial_noise(js, jnp.asarray(noise)))
