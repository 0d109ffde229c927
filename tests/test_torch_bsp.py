"""The port's belief-space iLQR against trajopt_tpu's, float64 on the CPU.

On LightDark-TO-v0 at T=8, 3 iterations: ``make_bsp_solver`` (scan) and the
plain version of K9 (``core/cuda_bsp``, the λ ladder as a batch axis) against
``jax.jit(make_bsp_solver)`` for the default, ``reg=2`` and goal weights
``mu_w=(-2, -2)`` (an indefinite value that drives the λ escalation), on
every ``BSPState`` field and the trace, at the tolerances of
tests/test_pallas_bsp.py:159-171; ``make_bsp_solver_batched`` (engines
``scan`` and ``cuda``, the latter K8's plain version) against JAX's batched
scan engine on three beliefs; the scan and cuda runners (the latter K10's
plain version) with the standard normals handed in against a JAX loop built
as tests/test_pallas_bsp.py:175-218 builds it, over 5 steps;
``run_bsp_mpc_batch``; the convert round trip; the raises.  The JAX solvers
are compiled once, as one program.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import trajopt_torch
import trajopt_tpu
from trajopt_torch.core import cuda_bsp
from trajopt_torch.parallel import bsp as port
from trajopt_torch.utils.convert import bsp_state_from_numpy, bsp_state_to_numpy, env_from_fields
from trajopt_tpu.core.ekf import EKF as JaxEKF
from trajopt_tpu.parallel import bsp as jax_bsp

torch.set_num_threads(1)

T, ITERS, STEPS = 8, 3, 5
F64 = dict(device="cpu", dtype=torch.float64)


def _compiled(f, *args):
    """``jax.jit(f)`` compiled for ``args`` without XLA's backend (LLVM)
    optimizations: a shorter compile, rounding that differs from the default
    compile's at the 1e-14 level."""
    return jax.jit(f).lower(*args).compile(
        {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True})
CONFIGS = {"default": ({}, {}), "reg2": ({}, {"reg": 2}),
           "indefinite": ({"mu_w": (-2.0, -2.0)}, {})}
MU0S = np.array([[2.0, 2.0], [2.4, 1.3], [1.1, 2.9]])
SIGMA0S = np.stack([np.diag([5.0, 1e-8]), np.diag([3.0, 0.5]), np.diag([1.0, 1e-8])])


def _envs(env_kw):
    jenv = trajopt_tpu.make("LightDark-TO-v0", **env_kw)
    return jenv, env_from_fields("LightDark-TO-v0", dataclasses.asdict(jenv))


@functools.lru_cache(maxsize=None)
def _jax_solvers():
    """One program: the three single-problem solves from a belief, and the
    batched scan engine on MU0S/SIGMA0S."""
    solvers = [jax_bsp.make_bsp_solver(_envs(ek)[0], T, nb_iter=ITERS, **kw)
               for ek, kw in CONFIGS.values()]
    batched = jax_bsp.make_bsp_solver_batched(_envs({})[0], T, nb_iter=ITERS, engine="scan")
    return _compiled(lambda mu0, sigma0, mu0s, sigma0s: (
        [s(mu0, sigma0) for s in solvers], batched(mu0s, sigma0s)),
        *_envs({})[0].init(), jnp.asarray(MU0S), jnp.asarray(SIGMA0S))


@functools.lru_cache(maxsize=None)
def _solves():
    jenv = _envs({})[0]
    out = _jax_solvers()(*jenv.init(), jnp.asarray(MU0S), jnp.asarray(SIGMA0S))
    return jax.tree.map(np.asarray, out)


def _check_state(state, trace, want_state, want_trace):
    """tests/test_pallas_bsp.py:159-171's tolerances."""
    np.testing.assert_allclose(trace.numpy(), want_trace, rtol=1e-9)
    for f in ("bref_mu", "bref_sigma", "uref", "K", "kff"):
        np.testing.assert_allclose(getattr(state, f).numpy(), getattr(want_state, f),
                                   rtol=1e-8, atol=1e-10, err_msg=f)
    for f in ("lmbda", "dlmbda", "last_return"):
        np.testing.assert_allclose(getattr(state, f).numpy(), getattr(want_state, f), rtol=1e-9,
                                   err_msg=f)
    np.testing.assert_array_equal(state.done.numpy(), want_state.done)


def _init(env):
    return tuple(v.to(torch.float64) for v in env.init())


@pytest.mark.parametrize("config", list(CONFIGS))
def test_solver_matches_jax(config):
    env_kw, kw = CONFIGS[config]
    env = _envs(env_kw)[1]
    want_state, want_trace = _solves()[0][list(CONFIGS).index(config)]
    state, trace = port.make_bsp_solver(env, T, nb_iter=ITERS, **kw, **F64)(*_init(env))
    _check_state(state, trace, want_state, want_trace)


@pytest.mark.parametrize("config", list(CONFIGS))
def test_k9_plain_matches_jax(config):
    env_kw, kw = CONFIGS[config]
    env = _envs(env_kw)[1]
    want_state, want_trace = _solves()[0][list(CONFIGS).index(config)]
    state, trace = cuda_bsp.make_cuda_bsp_solve(env, T, ITERS, **kw)(*_init(env))
    _check_state(state, trace, want_state, want_trace)
    if config == "indefinite":
        assert float(state.lmbda) > 1.0       # the λ ladder went past its first trial


@pytest.mark.parametrize("engine", ["scan", "cuda"])
def test_batched_solver_matches_jax(engine, monkeypatch):
    env = _envs({})[1]
    want_state, want_trace = _solves()[1]
    # solve.trials counts the backward passes (K8's launches on the card)
    name = "bsp_backward" if engine == "scan" else "cuda_bsp_backward_packed"
    backward, calls = getattr(port, name), []
    monkeypatch.setattr(port, name, lambda *a: calls.append(1) or backward(*a))
    solve = port.make_bsp_solver_batched(env, T, nb_iter=ITERS, engine=engine, **F64)
    state, trace = solve(torch.as_tensor(MU0S), torch.as_tensor(SIGMA0S))
    _check_state(state, trace, want_state, want_trace)
    assert solve.trials == len(calls) >= ITERS


@functools.lru_cache(maxsize=None)
def _reference_episode():
    """JAX's episode loop with every draw mean + chol(cov)·ε
    (tests/test_pallas_bsp.py:175-218), on normals made with numpy."""
    jenv = _envs({})[0]
    rng = np.random.default_rng(3)
    x0 = np.asarray(jenv.reset_state())
    eps0 = rng.standard_normal(jenv.obs_dim)
    eps_dyn = rng.standard_normal((STEPS, jenv.state_dim))
    eps_obs = rng.standard_normal((STEPS, jenv.obs_dim))
    filt = JaxEKF(jenv)
    innovate, inference = jax.jit(filt.innovate), jax.jit(filt.inference)
    solves = _jax_solvers()

    def chol_draw(mean, cov, eps):
        return mean + jnp.linalg.cholesky(cov) @ eps

    mu_b, cov_b = innovate(*jenv.init(), chol_draw(jenv.observe(x0), jenv.obs_noise(x0), eps0))
    x = jnp.asarray(x0)
    xs, mus, sigs, us, cs = [], [], [], [], []
    for s in range(STEPS):
        st, _ = solves(mu_b, cov_b, jnp.asarray(MU0S), jnp.asarray(SIGMA0S))[0][0]
        u = st.uref[0]
        xs.append(x)
        mus.append(mu_b)
        sigs.append(cov_b)
        us.append(u)
        cs.append(jenv.cost(mu_b, cov_b, u))
        xn = chol_draw(jenv.dynamics(x, u), jenv.dyn_noise(x, u), eps_dyn[s])
        obs = chol_draw(jenv.observe(xn), jenv.obs_noise(xn), eps_obs[s])
        mu_b, cov_b = inference(mu_b, cov_b, u, obs)
        x = xn
    ref = [np.asarray(jnp.stack(v)) for v in (xs + [x], mus + [mu_b], sigs + [cov_b], us, cs)]
    return x0, (eps0, eps_dyn, eps_obs), ref


@pytest.mark.parametrize("engine", ["scan", "cuda"])
def test_runner_matches_jax_loop(engine):
    x0, normals, ref = _reference_episode()
    env = _envs({})[1]
    run = port.make_bsp_mpc_runner(env, T, STEPS, nb_iter=ITERS, engine=engine, **F64)
    assert run.engine == engine
    out = run(torch.as_tensor(x0), normals=tuple(torch.as_tensor(n) for n in normals))
    for name, got, want in zip(("xs", "mus", "sigmas", "us", "cs"), out, ref):
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-7, atol=1e-9, err_msg=name)


def test_run_bsp_mpc_batch_draws_up_front():
    """Each episode on normals of its own, drawn before any runs, from the
    reset state; the same as the runner on bsp_episode_normals' draws."""
    env = trajopt_torch.make("LightDark-TO-v0")
    kw = dict(nb_iter=2, **F64)
    data = port.run_bsp_mpc_batch(env, torch.Generator().manual_seed(7), 2, 4, 2, **kw)
    assert data["x"].shape == (2, 3, 2) and data["sigma"].shape == (2, 3, 2, 2)
    assert data["u"].shape == (2, 2, 2) and data["c"].shape == (2, 2)
    gen = torch.Generator().manual_seed(7)
    draws = [port.bsp_episode_normals(env, gen, 2, **F64) for _ in range(2)]
    run = port.make_bsp_mpc_runner(env, 4, 2, engine="scan", **kw)
    for i, normals in enumerate(draws):
        for got, want in zip(run(env.reset_state().double(), normals=normals),
                             (data[k][i] for k in ("x", "mu", "sigma", "u", "c"))):
            assert torch.equal(got, want)
    assert not torch.equal(data["x"][0], data["x"][1])


def test_convert_round_trip():
    want_state, _ = _solves()[0][0]
    d = {f: np.asarray(getattr(want_state, f)) for f in want_state._fields}
    state = bsp_state_from_numpy(d, device="cpu")
    assert state.done.dtype == torch.bool and state.K.shape == (T, 2, 2)
    back = bsp_state_to_numpy(state)
    for f in want_state._fields:
        np.testing.assert_array_equal(back[f], d[f])


def test_unported_and_invalid_arguments_raise():
    env = trajopt_torch.make("LightDark-TO-v0")
    car = trajopt_torch.make("Car-TO-v0")
    for kw, row in (({"value_form": "sqrt"}, "11b"), ({"backward": "pscan"}, "11c"),
                    ({"differentiable": True}, "row 15"), ({"time_mesh": object()}, "row 17")):
        with pytest.raises(NotImplementedError, match=row):
            port.make_bsp_solver(env, T, **kw, **F64)
    with pytest.raises(NotImplementedError, match="row 17"):
        port.make_bsp_solver_batched(env, T, mesh=object(), **F64)
    with pytest.raises(NotImplementedError, match="11a"):
        port.make_bsp_mpc_runner(env, T, 2, belief_filter="sqrt", **F64)
    with pytest.raises(NotImplementedError, match="row 17"):
        port.run_bsp_mpc_batch(env, None, 2, T, 2, mesh=object(), **F64)
    with pytest.raises(NotImplementedError, match="11e"):
        port.make_bsp_mpc_runner(car, T, 2, engine="cuda", **F64)
    with pytest.raises(ValueError, match="128 lanes"):
        cuda_bsp.make_cuda_bsp_solve(env, 128)
    with pytest.raises(ValueError, match="128 lanes"):
        port.make_bsp_mpc_runner(env, T, 128, engine="cuda", **F64)
    for bad in (dict(engine="pallas"), dict(reg=3)):
        with pytest.raises(ValueError):
            port.make_bsp_solver_batched(env, T, **bad, **F64)
    with pytest.raises(ValueError, match="engine"):
        port.make_bsp_mpc_runner(env, T, 2, engine="pallas", **F64)
    with pytest.raises(ValueError, match="built for"):
        port.make_bsp_solver(env, T, **F64)(torch.zeros(2), torch.eye(2))
    with pytest.raises(ValueError, match="built for"):
        port.make_bsp_mpc_runner(env, T, 2, engine="cuda", **F64)(torch.zeros(2))
    # "auto" takes the kernel on a CUDA device (building it makes no tensor)
    assert port.make_bsp_mpc_runner(env, T, 2, **F64).engine == "scan"
    assert port.make_bsp_mpc_runner(env, T, 2, device=torch.device("cuda", 0)).engine == "cuda"
