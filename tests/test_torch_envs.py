"""Parity of the port's Cartpole environments (trajopt_torch/envs) with
trajopt_tpu's, float64 on the CPU: dynamics, cost, the tile protocol, the tile
physics of the rollout kernels, and JAX's derivative of ``clip`` at a bound.  The
jitted JAX references are frozen (``tests/make_torch_refs.py``)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import trajopt_torch
import trajopt_tpu
from trajopt_torch.core.cuda_rollout import tile_cost, tile_dynamics
from trajopt_torch.core.diff import linearize_dynamics_delta
from trajopt_torch.envs.base import clip
from trajopt_torch.utils.convert import env_from_fields
from trajopt_tpu.core import pallas_rollout as jax_tiles

from make_torch_refs import frozen

torch.set_num_threads(1)

RTOL = 1e-12

VARIANTS = [
    ("Cartpole-TO-v0", {}),
    ("Cartpole-TO-v1", {}),
    ("Cartpole-TO-v0", {"slew_rate": True}),
    ("Cartpole-TO-v1", {"periodic": True}),
]


def _envs(name, kw):
    jenv = trajopt_tpu.make(name, **kw)
    return jenv, env_from_fields(name, dataclasses.asdict(jenv))


def _samples(env, n=16, seed=0):
    """Random states and actions; some actions exactly at ±umax and some cart
    positions exactly at ±xmax[0], where the clips tie."""
    rng = np.random.default_rng(seed)
    x = np.asarray(env.x0) + rng.standard_normal((n, env.dm_state))
    u = 8.0 * rng.standard_normal((n, env.dm_act))
    u[:4] = np.where(np.arange(4)[:, None] % 2 == 0, 10.0, -10.0)
    x[4:6, 0] = [10.0, -10.0]
    ul = rng.standard_normal((n, env.dm_act))
    w = rng.uniform(0.5, 1.5, n)
    return x, u, ul, w


@pytest.mark.parametrize("name,kw", VARIANTS)
def test_dynamics_and_cost_match(name, kw):
    jenv, tenv = _envs(name, kw)
    x, u, ul, w = _samples(jenv)
    xn_j, c_j = frozen(__file__, f"dynamics-cost-{name}-{kw}", lambda: (
        jax.jit(jax.vmap(jenv.dynamics))(jnp.asarray(x), jnp.asarray(u)),
        jax.jit(jax.vmap(jenv.cost))(jnp.asarray(x), jnp.asarray(u), jnp.asarray(ul),
                                     jnp.asarray(w))))
    xn_t = tenv.dynamics(torch.as_tensor(x), torch.as_tensor(u))
    np.testing.assert_allclose(xn_t.numpy(), np.asarray(xn_j), rtol=RTOL, atol=1e-13)
    c_t = tenv.cost(torch.as_tensor(x), torch.as_tensor(u), torch.as_tensor(ul),
                    torch.as_tensor(w))
    np.testing.assert_allclose(c_t.numpy(), np.asarray(c_j), rtol=RTOL)


@pytest.mark.parametrize("name,kw", VARIANTS)
def test_tile_protocol_matches(name, kw):
    jenv, tenv = _envs(name, kw)
    assert tenv.supports_tiles == jenv.supports_tiles
    assert tenv.supports_tile_quadratization == jenv.supports_tile_quadratization
    x, u, ul, w = _samples(jenv, seed=1)
    xj = [jnp.asarray(x[:, i]) for i in range(x.shape[1])]
    uj = [jnp.asarray(u[:, j]) for j in range(u.shape[1])]
    ulj = [jnp.asarray(ul[:, j]) for j in range(u.shape[1])]
    xt = [torch.as_tensor(x[:, i]) for i in range(x.shape[1])]
    ut = [torch.as_tensor(u[:, j]) for j in range(u.shape[1])]
    ult = [torch.as_tensor(ul[:, j]) for j in range(u.shape[1])]
    pairs = [
        (jenv._ode_parts(xj, uj), tenv._ode_parts(xt, ut)),
        (jenv._periodic_parts(xj), tenv._periodic_parts(xt)),
        (jenv.features_parts(xj), tenv.features_parts(xt)),
        (jax_tiles.tile_dynamics(jenv, xj, uj), tile_dynamics(tenv, xt, ut)),
    ]
    for pj, pt in pairs:
        assert len(pj) == len(pt)
        for a, b in zip(pj, pt):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=RTOL, atol=1e-13)
    cj = jax_tiles.tile_cost(jenv, xj, uj, ulj, jnp.asarray(w))
    ct = tile_cost(tenv, xt, ut, ult, torch.as_tensor(w))
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), rtol=RTOL)


def test_clip_tie_gradient_matches_jax():
    """jnp.clip's derivative is 0.5 exactly at a bound (torch.clamp's is 1):
    the port's clip must give JAX's 1 / 0.5 / 0 in both AD modes."""
    vals = np.array([3.0, 10.0, -10.0, 11.0, -12.0])
    g_j = frozen(__file__, "clip-grad", lambda: jax.jit(jax.vmap(jax.grad(
        lambda u: jnp.clip(u, -10.0, 10.0))))(jnp.asarray(vals)))
    lo, hi = torch.tensor(-10.0, dtype=torch.float64), torch.tensor(10.0, dtype=torch.float64)

    def f(u):
        return clip(u, lo, hi)

    u = torch.as_tensor(vals)
    g_rev = torch.func.vmap(torch.func.grad(f))(u)
    g_fwd = torch.func.vmap(torch.func.jacfwd(f))(u)
    np.testing.assert_array_equal(g_j, [1.0, 0.5, 0.5, 0.0, 0.0])
    np.testing.assert_array_equal(g_rev.numpy(), g_j)
    np.testing.assert_array_equal(g_fwd.numpy(), g_j)


@pytest.mark.parametrize("name,kw", VARIANTS[:2])
def test_linearization_at_saturation_matches(name, kw):
    """A, B at saturated actions and at the cart-position bound carry the
    tie-rule halving exactly as JAX's jacfwd does."""
    from trajopt_tpu.core.diff import linearize_dynamics_delta as jax_lin

    jenv, tenv = _envs(name, kw)
    x, u, _, _ = _samples(jenv, seed=2)
    A_j, B_j = frozen(__file__, f"linearization-{name}-{kw}", lambda: jax.jit(
        lambda a, b: jax_lin(jenv.dynamics, a, b))(jnp.asarray(x), jnp.asarray(u)))
    A_t, B_t = linearize_dynamics_delta(tenv.dynamics, torch.as_tensor(x), torch.as_tensor(u))
    np.testing.assert_allclose(A_t.numpy(), np.asarray(A_j), rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(B_t.numpy(), np.asarray(B_j), rtol=1e-10, atol=1e-12)
    # the saturated rows really are halved relative to an interior action
    _, B_in = linearize_dynamics_delta(
        tenv.dynamics, torch.as_tensor(x[:1]), torch.as_tensor([[9.999999]])
    )
    np.testing.assert_allclose(B_t[0].numpy(), 0.5 * B_in[0].numpy(), rtol=1e-4)


def test_registry_and_fields():
    assert set(trajopt_torch.registered()) == {
        "Car-TO-v0", "Cartpole-TO-v0", "Cartpole-TO-v1", "LightDark-TO-v0", "LQR-TO-v0",
        "LQR-TO-v1", "LQR-TO-v2", "Pendulum-TO-v0", "Pendulum-TO-v1", "Robot-TO-v0",
    }
    for name in trajopt_torch.registered():
        jenv = trajopt_tpu.make(name)
        tenv = trajopt_torch.make(name)
        assert dataclasses.asdict(tenv) == dataclasses.asdict(jenv)
    env = env_from_fields("Cartpole-TO-v0", {"dt": np.float64(0.02), "umax": np.array([5.0])})
    assert env.dt == 0.02 and env.umax == (5.0,)
    with pytest.raises(ValueError, match="no fields"):
        env_from_fields("Cartpole-TO-v0", {"mass": 1.0})


@pytest.mark.parametrize("name", ["Cartpole-TO-v0", "Cartpole-TO-v1"])
def test_float32_stays_float32(name):
    """Linearization and quadratization keep float32 inputs in float32 (the
    kernels refuse mixed dtypes)."""
    from trajopt_torch.core.diff import quadratize_cost_delta

    env = trajopt_torch.make(name, periodic=True)
    x = torch.zeros(3, 5, 4)
    u = torch.ones(3, 4, 1)
    A, B = linearize_dynamics_delta(env.dynamics, x[:, :4], u)
    cost = quadratize_cost_delta(env.cost, x, u, torch.ones(5))
    for t in (A, B, *cost):
        assert t.dtype == torch.float32
