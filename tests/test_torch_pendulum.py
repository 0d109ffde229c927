"""Parity of the port's Pendulum environments (trajopt_torch/envs/pendulum.py)
with trajopt_tpu's, float64 on the CPU: dynamics, cost, linearization and
quadratization (actions exactly at ±umax among the samples), the tile
protocol, and the stochastic interface (noise, init, the noisy step).  The
jitted JAX references are frozen (``tests/make_torch_refs.py``)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import trajopt_tpu
from trajopt_torch.core.cuda_rollout import tile_cost, tile_dynamics
from trajopt_torch.core.diff import linearize_dynamics_delta, quadratize_cost_delta
from trajopt_torch.utils.convert import env_from_fields
from trajopt_tpu.core import diff as jax_diff
from trajopt_tpu.core import pallas_rollout as jax_tiles

from make_torch_refs import frozen

torch.set_num_threads(1)

TOL = dict(rtol=1e-10, atol=1e-12)

VARIANTS = [
    ("Pendulum-TO-v0", {"dt": 0.05}),
    ("Pendulum-TO-v1", {}),
    ("Pendulum-TO-v0", {"slew_rate": True, "periodic": True}),
]


def _envs(name, kw):
    jenv = trajopt_tpu.make(name, **kw)
    return jenv, env_from_fields(name, dataclasses.asdict(jenv))


def _samples(env, n=12, seed=0):
    """Random states and actions, the first four actions exactly at ±umax."""
    rng = np.random.default_rng(seed)
    x = np.asarray(env.x0) + 2.0 * rng.standard_normal((n, env.dm_state))
    u = 8.0 * rng.standard_normal((n, env.dm_act))
    u[:4] = np.where(np.arange(4)[:, None] % 2 == 0, 10.0, -10.0)
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
    np.testing.assert_allclose(xn_t.numpy(), np.asarray(xn_j), **TOL)
    c_t = tenv.cost(torch.as_tensor(x), torch.as_tensor(u), torch.as_tensor(ul),
                    torch.as_tensor(w))
    np.testing.assert_allclose(c_t.numpy(), np.asarray(c_j), **TOL)


@pytest.mark.parametrize("name,kw", VARIANTS[:2])
def test_linearization_and_quadratization_match(name, kw):
    """A, B along a trajectory whose actions hit ±umax (JAX's clip tie rule
    halves B there) and the delta-convention cost expansion."""
    jenv, tenv = _envs(name, kw)
    x, u, _, w = _samples(jenv, n=9, seed=1)
    xs, us = x.reshape(3, 3, 2), u[:6].reshape(3, 2, 1)       # 3 trajectories, T = 2
    (A_j, B_j), c_j = frozen(__file__, f"expansions-{name}-{kw}", lambda: (
        jax.jit(lambda a, b: jax_diff.linearize_dynamics_delta(jenv.dynamics, a, b))(
            jnp.asarray(x), jnp.asarray(u)),
        jax.jit(jax.vmap(lambda a, b: jax_diff.quadratize_cost_delta(
            jenv.cost, a, b, jnp.asarray(w[:3]))))(jnp.asarray(xs), jnp.asarray(us))))
    A_t, B_t = linearize_dynamics_delta(tenv.dynamics, torch.as_tensor(x), torch.as_tensor(u))
    np.testing.assert_allclose(A_t.numpy(), np.asarray(A_j), **TOL)
    np.testing.assert_allclose(B_t.numpy(), np.asarray(B_j), **TOL)
    # at ±umax the control column is half the interior one
    _, B_in = linearize_dynamics_delta(tenv.dynamics, torch.as_tensor(x[:1]),
                                       torch.as_tensor([[9.999999]]))
    np.testing.assert_allclose(B_t[0].numpy(), 0.5 * B_in[0].numpy(), rtol=1e-4)

    c_t = quadratize_cost_delta(tenv.cost, torch.as_tensor(xs), torch.as_tensor(us),
                                torch.as_tensor(w[:3]))
    for k in ("Cxx", "cx", "Cuu", "cu", "Cxu"):
        np.testing.assert_allclose(getattr(c_t, k).numpy(), np.asarray(getattr(c_j, k)),
                                   err_msg=k, **TOL)


@pytest.mark.parametrize("name,kw", VARIANTS)
def test_tile_protocol_matches(name, kw):
    jenv, tenv = _envs(name, kw)
    assert tenv.supports_tiles == jenv.supports_tiles
    assert tenv.supports_tile_quadratization == jenv.supports_tile_quadratization
    x, u, ul, w = _samples(jenv, seed=2)
    xj = [jnp.asarray(x[:, i]) for i in range(2)]
    uj, ulj = [jnp.asarray(u[:, 0])], [jnp.asarray(ul[:, 0])]
    xt = [torch.as_tensor(x[:, i]) for i in range(2)]
    ut, ult = [torch.as_tensor(u[:, 0])], [torch.as_tensor(ul[:, 0])]
    pairs = [
        (jenv._ode_parts(xj, uj), tenv._ode_parts(xt, ut)),
        (jenv._periodic_parts(xj), tenv._periodic_parts(xt)),
        (jenv.features_parts(xj), tenv.features_parts(xt)),
        (jax_tiles.tile_dynamics(jenv, xj, uj), tile_dynamics(tenv, xt, ut)),
    ]
    for pj, pt in pairs:
        assert len(pj) == len(pt)
        for a, b in zip(pj, pt):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), **TOL)
    cj = jax_tiles.tile_cost(jenv, xj, uj, ulj, jnp.asarray(w))
    ct = tile_cost(tenv, xt, ut, ult, torch.as_tensor(w))
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), **TOL)


def test_stochastic_interface_matches():
    """sigma, sigma0, init and noise as JAX's; the noisy step with JAX's
    additive draw handed in lands on JAX's step; sample_init and the step's
    own draw are ``mean + chol(cov) z`` with ``z`` from the generator."""
    jenv, tenv = _envs("Pendulum-TO-v0", {"dt": 0.05, "sigma_scale": 3e-2})
    for a, b in ((tenv.sigma, jenv.sigma), (tenv.sigma0, jenv.sigma0),
                 (tenv.init()[0], jenv.init()[0]), (tenv.init()[1], jenv.init()[1]),
                 (tenv.noise(), jenv.noise())):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))

    x, u, _, _ = _samples(jenv, n=4, seed=3)
    keys = jax.random.split(jax.random.PRNGKey(5), 4)
    zero = jnp.zeros(2)
    xn_j, eps = frozen(__file__, "step", lambda: (
        jax.jit(jax.vmap(jenv.step))(keys, jnp.asarray(x), jnp.asarray(u)),
        jax.jit(jax.vmap(lambda k: jax.random.multivariate_normal(k, zero, jenv.sigma)))(keys)))
    xn_t = tenv.step(None, torch.as_tensor(x), torch.as_tensor(u), torch.tensor(np.asarray(eps)))
    np.testing.assert_allclose(xn_t.numpy(), np.asarray(xn_j), **TOL)

    sd = np.sqrt(3e-2)
    xt, ut = torch.as_tensor(x), torch.as_tensor(u)
    z = torch.randn(4, 2, generator=torch.Generator().manual_seed(7), dtype=torch.float64)
    drawn = tenv.step(torch.Generator().manual_seed(7), xt, ut)
    np.testing.assert_allclose(drawn.numpy(), (tenv.dynamics(xt, ut) + sd * z).numpy(), **TOL)
    z0 = torch.randn(2, generator=torch.Generator().manual_seed(8), dtype=torch.float64)
    x0 = tenv.sample_init(torch.Generator().manual_seed(8), dtype=torch.float64, device="cpu")
    np.testing.assert_allclose(x0.numpy(), np.asarray(jenv.x0) + 1e-2 * z0.numpy(), **TOL)


def test_noise_factor_is_factored_once():
    """The noisy step reuses one ``chol(sigma)`` per env, dtype and device;
    an env with other fields gets its own."""
    _, tenv = _envs("Pendulum-TO-v0", {"dt": 0.05, "sigma_scale": 3e-2})
    f64 = tenv.noise_factor(torch.float64, "cpu")
    np.testing.assert_allclose(f64.numpy(), np.sqrt(3e-2) * np.eye(2), **TOL)
    assert tenv.noise_factor(torch.float64, torch.device("cpu")) is f64
    assert tenv.noise_factor(torch.float32, "cpu").dtype == torch.float32
    other = tenv.replace(sigma_scale=4e-2).noise_factor(torch.float64, "cpu")
    np.testing.assert_allclose(other.numpy(), 0.2 * np.eye(2), **TOL)


def test_unbounded_state_passes_through_clip():
    """xmax = (inf, inf): the state clip changes no value and no derivative."""
    _, tenv = _envs("Pendulum-TO-v0", {})
    x = torch.tensor([[1e30, -1e30], [3.0, -2.0]], dtype=torch.float64)
    assert torch.equal(tenv.clip_state(x), x)
    jac = torch.func.vmap(torch.func.jacfwd(tenv.clip_state))(x)
    np.testing.assert_array_equal(jac.numpy(), np.broadcast_to(np.eye(2), (2, 2, 2)))
