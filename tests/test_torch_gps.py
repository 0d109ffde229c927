"""The port's model-based GPS against trajopt_tpu's, float64 on the CPU.

LQR-TO-v0/v1/v2 dynamics and cost; the absolute-convention expansions
(``linearize_dynamics``, ``quadratize_cost_abs``, ``evaluate_quadratic_cost``)
and ``extended_kalman`` on Pendulum, with actions exactly at ±umax;
``make_mbgps_solver`` (scalar dual, with the adaptive bound, and
``kl_stepwise``) on LQR-TO-v0 and Pendulum at T=6; ``make_mbgps_solver_batched``
with ``engine="scan"`` and ``"cuda"`` (K6/K7's plain versions on CPU tensors)
against JAX's ``engine="scan"`` on JAX's own configuration
(tests/test_pallas_gps.py: LQR-TO-v0, sigma_scale=1e-4, N=3, T=10,
nb_iter=2, bisect_iters=8); the GPS state's round trip through numpy; the
unported options raise.  The initial kff is JAX's draw, handed in.  Each JAX
reference is compiled once, the four single-problem solves as one program."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import trajopt_torch
import trajopt_tpu
from trajopt_torch.core import diff as port_diff
from trajopt_torch.core.ekf import extended_kalman
from trajopt_torch.core.types import LinearGaussianPolicy
from trajopt_torch.parallel import gps as port
from trajopt_torch.utils.convert import env_from_fields, gps_state_from_numpy, gps_state_to_numpy
from trajopt_tpu.core import diff as jax_diff
from trajopt_tpu.core import ekf as jax_ekf
from trajopt_tpu.core.types import LinearGaussianPolicy as JaxPolicy
from trajopt_tpu.parallel import gps as jax_gps

torch.set_num_threads(1)

TOL = dict(rtol=1e-10, atol=1e-12)
TRACE_TOL = dict(rtol=1e-7)
STATE_TOL = dict(rtol=1e-8, atol=1e-12)
F64 = dict(device="cpu", dtype=torch.float64)


def _compiled(f, *args):
    """``jax.jit(f)`` compiled for ``args`` without XLA's backend (LLVM)
    optimizations: a shorter compile, rounding that differs from the default
    compile's at the 1e-14 level."""
    return jax.jit(f).lower(*args).compile(
        {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True})


def _envs(name, **kw):
    jenv = trajopt_tpu.make(name, **kw)
    return jenv, env_from_fields(name, dataclasses.asdict(jenv))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _close(got, want, tol):
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w, **tol)


@pytest.mark.parametrize("name", ["LQR-TO-v0", "LQR-TO-v1", "LQR-TO-v2"])
def test_lqr_dynamics_and_cost_match(name):
    jenv, tenv = _envs(name)
    rng = np.random.default_rng(0)
    x = np.asarray(jenv.x0) + 3.0 * rng.standard_normal((6, 2))
    u, ul, w = rng.standard_normal((6, 1)), rng.standard_normal((6, 1)), rng.uniform(0.5, 1.5, 6)
    xn = jax.jit(jax.vmap(jenv.dynamics))(jnp.asarray(x), jnp.asarray(u))
    np.testing.assert_allclose(tenv.dynamics(torch.as_tensor(x), torch.as_tensor(u)).numpy(),
                               np.asarray(xn), **TOL)
    c = jax.jit(jax.vmap(jenv.cost))(*(jnp.asarray(a) for a in (x, u, ul, w)))
    np.testing.assert_allclose(tenv.cost(*(torch.as_tensor(a) for a in (x, u, ul, w))).numpy(),
                               np.asarray(c), **TOL)
    np.testing.assert_allclose(tenv.sigma.numpy(), np.asarray(jenv.sigma), rtol=0)
    np.testing.assert_allclose(tenv.init()[1].numpy(), np.asarray(jenv.init()[1]), rtol=0)


def test_lqr_interfaces_of_later_slices_raise():
    env = trajopt_torch.make("LQR-TO-v1")
    x, u = torch.zeros(2, dtype=torch.float64), torch.zeros(1, dtype=torch.float64)
    with pytest.raises(NotImplementedError, match="row 12"):
        env.inverse_dynamics(x, u)
    for method in (env.dynamics_dist, env.evolve):
        with pytest.raises(NotImplementedError, match="row 13"):
            method(None, x, u, None, None)


@pytest.fixture(scope="module")
def pendulum():
    """Pendulum (dt=0.05) trajectories of 2 instances, T=6, whose actions hit
    ±umax at steps 1 and 4, a linear-Gaussian policy whose feedforward
    saturates at those steps, and JAX's expansions and EKF on them (one
    compiled reference)."""
    jenv, tenv = _envs("Pendulum-TO-v0", dt=0.05)
    rng = np.random.default_rng(1)
    N, T = 2, 6
    xs = np.asarray(jenv.x0) + 0.5 * rng.standard_normal((N, T + 1, 2))
    us = 3.0 * rng.standard_normal((N, T, 1))
    us[:, 1], us[:, 4] = 10.0, -10.0
    w = rng.uniform(0.5, 1.5, T + 1)
    kff = 2.0 * rng.standard_normal((N, T, 1))
    kff[:, 1], kff[:, 4] = 50.0, -50.0
    M = rng.standard_normal((N, T, 1, 1))
    pol = dict(K=0.3 * rng.standard_normal((N, T, 1, 2)), kff=kff, sigma=M * M + 0.5)
    mu0 = np.asarray(jenv.x0) + 0.1 * rng.standard_normal((N, 2))
    sigma0 = np.tile(1e-2 * np.eye(2), (N, 1, 1))

    def one(x, u, K, k, sig, m0, s0):
        cost = jax_diff.quadratize_cost_abs(jenv.cost, x, u, jnp.asarray(w))
        return (jax_diff.linearize_dynamics(jenv.dynamics, x[:-1], u), cost,
                jax_diff.evaluate_quadratic_cost(cost, x, u),
                jax_ekf.extended_kalman(jenv, JaxPolicy(K=K, kff=k, sigma=sig), m0, s0))

    ref = _np(jax.jit(jax.vmap(one))(
        *(jnp.asarray(a) for a in (xs, us, pol["K"], pol["kff"], pol["sigma"], mu0, sigma0))))
    return dict(tenv=tenv, xs=xs, us=us, w=w, pol=pol, mu0=mu0, sigma0=sigma0, ref=ref)


def test_linearize_dynamics_matches(pendulum):
    p = pendulum
    got = port_diff.linearize_dynamics(p["tenv"].dynamics, torch.as_tensor(p["xs"][:, :-1]),
                                       torch.as_tensor(p["us"]))
    _close(got, p["ref"][0], TOL)


def test_quadratize_cost_abs_and_evaluate_match(pendulum):
    p = pendulum
    xs, us = torch.as_tensor(p["xs"]), torch.as_tensor(p["us"])
    cost = port_diff.quadratize_cost_abs(p["tenv"].cost, xs, us, torch.as_tensor(p["w"]))
    _close(cost, p["ref"][1], dict(rtol=1e-10, atol=1e-9))
    np.testing.assert_allclose(port_diff.evaluate_quadratic_cost(cost, xs, us).numpy(),
                               p["ref"][2], rtol=1e-10)


def test_extended_kalman_matches(pendulum):
    p = pendulum
    pol = LinearGaussianPolicy(*(torch.as_tensor(p["pol"][k]) for k in ("K", "kff", "sigma")))
    got = extended_kalman(p["tenv"], pol, torch.as_tensor(p["mu0"]), torch.as_tensor(p["sigma0"]))
    for g, r in zip(got, p["ref"][3]):
        _close(g, r, TOL)
    # the clipped mean actions sit exactly at ±umax, where B is halved
    assert np.all(np.abs(got[1].mu[:, [1, 4]].numpy()) == 10.0)


SINGLE = [
    ("LQR-TO-v0", dict(sigma_scale=1e-4), dict(kl_stepwise=False)),
    ("LQR-TO-v0", dict(sigma_scale=1e-4), dict(kl_stepwise=True)),
    ("Pendulum-TO-v0", dict(dt=0.05), dict(kl_stepwise=False, kl_adaptive=True)),
    ("Pendulum-TO-v0", dict(dt=0.05), dict(kl_stepwise=True)),
]
SINGLE_KW = dict(nb_iter=2, kl_bound=2.0, bisect_iters=12, action_penalty=1e-5)


@pytest.fixture(scope="module")
def single_ref():
    """JAX's single-problem solves of every case of SINGLE at T=6, as one
    compiled program, with the key's initial kff."""
    T, key = 6, jax.random.PRNGKey(3)
    solvers, inits = [], []
    for name, env_kw, kw in SINGLE:
        jenv = trajopt_tpu.make(name, **env_kw)
        solvers.append(jax_gps.make_mbgps_solver(jenv, T, **SINGLE_KW, **kw))
        inits.append(tuple(jnp.asarray(np.asarray(a)) for a in jenv.init()))
    outs = _compiled(lambda a: [solve(key, *x) for solve, x in zip(solvers, a)], inits)(inits)
    kff0 = 1e-4 * np.asarray(jax.random.normal(key, (T, 1), jnp.float64))
    return T, kff0, [(_np(x), _np(o)) for x, o in zip(inits, outs)]


@pytest.mark.parametrize(
    "case", range(len(SINGLE)),
    ids=["lqr-scalar", "lqr-stepwise", "pendulum-adaptive", "pendulum-stepwise"])
def test_mbgps_solver_matches_jax(single_ref, case):
    name, env_kw, kw = SINGLE[case]
    _, tenv = _envs(name, **env_kw)
    T, kff0, refs = single_ref
    (mu0, sigma0), (jstate, jtrace) = refs[case]
    solve = port.make_mbgps_solver(tenv, T, **SINGLE_KW, **kw, **F64)
    state, trace = solve(torch.as_tensor(mu0), torch.as_tensor(sigma0),
                         kff_init=torch.as_tensor(kff0))
    np.testing.assert_allclose(trace.numpy(), jtrace, **TRACE_TOL)
    _close(state.ctl, jstate.ctl, STATE_TOL)
    np.testing.assert_allclose(state.alpha.numpy(), jstate.alpha, **STATE_TOL)
    np.testing.assert_allclose(state.kl_mult.numpy(), jstate.kl_mult, **STATE_TOL)
    assert trace[-1] < trace[0]


@pytest.fixture(scope="module")
def batched_ref():
    """JAX's batched scan engine on its own test configuration."""
    jenv, tenv = _envs("LQR-TO-v0", sigma_scale=1e-4)
    N, T = 3, 10
    keys = jax.random.split(jax.random.PRNGKey(0), N)
    mu0, sigma0 = jenv.init()
    mu0s = np.tile(np.asarray(mu0), (N, 1)) + 0.05 * np.arange(N)[:, None]
    sigma0s = np.tile(np.asarray(sigma0), (N, 1, 1))
    solve = jax_gps.make_mbgps_solver_batched(jenv, T, nb_iter=2, kl_bound=2.0, bisect_iters=8,
                                              engine="scan")
    args = (keys, jnp.asarray(mu0s), jnp.asarray(sigma0s))
    jstate, jtrace = _compiled(solve, *args)(*args)
    kff0 = 1e-4 * np.asarray(jax.vmap(lambda k: jax.random.normal(k, (T, 1), jnp.float64))(keys))
    return dict(tenv=tenv, T=T, mu0s=mu0s, sigma0s=sigma0s, kff0=kff0, jstate=jstate,
                jtrace=np.asarray(jtrace))


@pytest.mark.parametrize("engine", ["scan", "cuda"])
def test_mbgps_solver_batched_matches_jax(batched_ref, engine):
    from trajopt_torch.core.cuda_gps import cuda_gps_backward_packed, cuda_gps_forward_kl_packed

    r = batched_ref
    solve = port.make_mbgps_solver_batched(r["tenv"], r["T"], nb_iter=2, kl_bound=2.0,
                                           bisect_iters=8, engine=engine, **F64)
    state, trace = solve(*(torch.as_tensor(r[k]) for k in ("mu0s", "sigma0s")),
                         kff_init=torch.as_tensor(r["kff0"]))
    assert trace.shape == (3, 3)
    np.testing.assert_allclose(trace.numpy(), r["jtrace"], **TRACE_TOL)
    want = gps_state_to_numpy(gps_state_from_numpy(
        {k: (v._asdict() if hasattr(v, "_asdict") else v)
         for k, v in r["jstate"]._asdict().items()},
        device="cpu"))
    got = gps_state_to_numpy(state)
    for name, value in want.items():
        pairs = value.items() if isinstance(value, dict) else [("", value)]
        for field, w in pairs:
            g = got[name][field] if field else got[name]
            np.testing.assert_allclose(g, w, err_msg=f"{name}.{field}", **STATE_TOL)
    # CPU tensors run K6/K7's plain versions: no launch is counted
    assert cuda_gps_backward_packed.launches == cuda_gps_forward_kl_packed.launches == 0


def test_gps_state_round_trip(batched_ref):
    jstate = batched_ref["jstate"]
    d = {k: (_np(v._asdict()) if hasattr(v, "_asdict") else np.asarray(v))
         for k, v in jstate._asdict().items()}
    state = gps_state_from_numpy(d, device="cpu")
    assert isinstance(state, port.GPSState)
    assert state.ctl.K.dtype == torch.float64 and state.ctl.K.shape == (3, 10, 1, 2)
    back = gps_state_to_numpy(state)
    assert set(back) == set(d)
    for k, v in d.items():
        for f, a in (v.items() if isinstance(v, dict) else [(None, v)]):
            np.testing.assert_array_equal(back[k][f] if f else back[k], a)


def test_unported_options_raise():
    env = trajopt_torch.make("LQR-TO-v0")
    with pytest.raises(NotImplementedError, match="row 15"):
        port.make_mbgps_solver(env, 5, differentiable=True, **F64)
    with pytest.raises(NotImplementedError, match="row 17"):
        port.make_mbgps_solver(env, 5, time_mesh=object(), **F64)
    with pytest.raises(ValueError, match="engine"):
        port.make_mbgps_solver_batched(env, 5, engine="pallas", **F64)
