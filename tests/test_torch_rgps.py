"""The port's compiled robust GPS against trajopt_tpu's, float64 on the CPU.

``make_rgps_solver`` (``parallel/rgps``) against JAX's at short horizons with
the searches cut (``beta_iters``, ``fp_iters``, ``alpha_bisect_iters``,
rounds and grids; stated per case): ``lr`` on LQR-TO-v1 (T=4 or 6, 1 or
2 iterations) with both β and both α searches on both fixed-point engines (``cuda`` runs
K15/K16's plain versions on CPU tensors), the regularized adversary, the W2
geodesic, the stepwise policy dual and a fixed adversary on the scan engine;
``mb`` on Pendulum-TO-v0 (both engines) and on Robot-TO-v0 (scan; its p = 28
plain kernels are slow on a CPU).  Traces, controllers and duals at rtol
1e-8: the port repeats JAX's arithmetic, so the searches take the same
branches.  ``run_rgps_batch`` on three perturbed problems (the initial
states JAX draws, handed in); a JAX ``RGPSState`` carried across through
numpy continues for one iteration onto JAX's next; the unported options
raise; JAX's float64 traces at chip_smoke.py's main-path configurations,
which the card's run is held to.  Every JAX solve is frozen
(``tests/make_torch_refs.py``)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import trajopt_torch
import trajopt_tpu
from trajopt_torch.parallel import rgps as port
from trajopt_torch.utils.convert import (
    env_from_fields,
    matrix_normal_from_numpy,
    matrix_normal_to_numpy,
    rgps_state_from_numpy,
    rgps_state_to_numpy,
)
from trajopt_tpu.parallel import rgps as jax_rgps

from make_torch_refs import reference

torch.set_num_threads(1)

TOL = dict(rtol=1e-8, atol=1e-10)
F64 = dict(device="cpu", dtype=torch.float64)
LQR = ("LQR-TO-v1", {})
PENDULUM = ("Pendulum-TO-v0", {"dt": 0.05})
ROBOT = ("Robot-TO-v0", {"sigma_scale": 1e-4})
BASE = dict(init_action_sigma=10.0, policy_kl_bound=0.25, param_nominal_kl_bound=50.0,
            nominal_variance=1e-8, beta_iters=8, fp_iters=10, alpha_bisect_iters=16)
PARALLEL = dict(beta_search="parallel", beta_rounds=2, beta_grid=4, alpha_search="parallel",
                alpha_rounds=3, alpha_grid=4)
CASES = {
    "lr-bisect": (LQR, "lr", 4, 1, dict(beta_iters=20)),
    "lr-parallel": (LQR, "lr", 6, 2, PARALLEL),
    "lr-iterative": (LQR, "lr", 6, 1, dict(iterative_adversary=True, reg_steps=2, eta_iters=4,
                                           param_regularizer_kl_bound=1.0)),
    "lr-w2": (LQR, "lr", 6, 1, dict(interp="w2")),
    "lr-stepwise": (LQR, "lr", 6, 1, dict(policy_kl_stepwise=True)),
    "lr-fixed-adversary": (LQR, "lr", 6, 1, dict(optimize_adversary=False)),
    "mb-pendulum": (PENDULUM, "mb", 6, 1, dict(init_action_sigma=1.0, policy_kl_bound=1.0)),
    "mb-robot": (ROBOT, "mb", 3, 1, dict(init_action_sigma=1.0, policy_kl_bound=1.0)),
}
ENGINES = {"lr-bisect": ("scan", "cuda"), "lr-parallel": ("scan", "cuda"),
           "mb-pendulum": ("scan", "cuda")}


def _kw(case):
    (name, env_kw), variant, T, it, kw = CASES[case]
    return name, env_kw, T, dict(BASE, variant=variant, nb_iter=it, **kw)


def _envs(name, env_kw):
    jenv = trajopt_tpu.make(name, **env_kw)
    return jenv, env_from_fields(name, dataclasses.asdict(jenv))


def _state_dict(state):
    return {k: (v._asdict() if hasattr(v, "_asdict") else v)
            for k, v in state._asdict().items() if k != "key"}


@reference(__file__)
def _jax_solve(case):
    name, env_kw, T, kw = _kw(case)
    jenv = _envs(name, env_kw)[0]
    mu0, sigma0 = (jnp.asarray(np.asarray(a)) for a in jenv.init())
    state, trace = jax.jit(jax_rgps.make_rgps_solver(jenv, T, fp_engine="scan", **kw))(mu0, sigma0)
    return _state_dict(state), trace


def _check(state, trace, want_state, want_trace):
    np.testing.assert_allclose(trace.numpy(), want_trace, **TOL)
    got = rgps_state_to_numpy(state)
    for name in ("ctl", "xdist", "cost", "nominal"):
        for f, w in want_state[name].items():
            np.testing.assert_allclose(got[name][f], w, err_msg=f"{name}.{f}", **TOL)
    for name in ("last_return", "beta", "alpha"):
        np.testing.assert_allclose(got[name], want_state[name], err_msg=name, **TOL)


@pytest.mark.parametrize("case,engine", [(c, e) for c in CASES for e in ENGINES.get(c, ("scan",))])
def test_solver_matches_jax(case, engine):
    name, env_kw, T, kw = _kw(case)
    env = _envs(name, env_kw)[1]
    want_state, want_trace = _jax_solve(case)
    solve = port.make_rgps_solver(env, T, fp_engine=engine, **kw, **F64)
    assert solve.batched.fp_engine == engine
    state, trace = solve(*(x.double() for x in env.init()))
    _check(state, trace, want_state, want_trace)
    if case == "lr-bisect":
        # the β-bisection stopped early (fewer fixed points than the
        # reference's fixed-length scan runs) and every output still agrees
        assert solve.batched.fixed_points < kw["nb_iter"] * (kw["beta_iters"] + 1)


# chip_smoke.py's main-path configurations (bench.py:834; examples/rgps/
# mb_robot.py): the card's float32 traces are held to these float64 ones
MAIN_PATHS = {
    "lqr": (LQR, "lr", 60, dict(nb_iter=2, init_action_sigma=10.0, policy_kl_bound=0.25,
                                param_nominal_kl_bound=50.0, nominal_variance=1e-8)),
    "robot": (ROBOT, "mb", 50, dict(nb_iter=2, init_action_sigma=1.0, policy_kl_bound=1.0,
                                    param_nominal_kl_bound=50.0, nominal_variance=1e-8)),
}


@reference(__file__)
def _jax_main_path_trace(cfg):
    (name, env_kw), variant, T, kw = MAIN_PATHS[cfg]
    jenv = _envs(name, env_kw)[0]
    mu0, sigma0 = (jnp.asarray(np.asarray(a)) for a in jenv.init())
    solve = jax_rgps.make_rgps_solver(jenv, T, variant=variant, fp_engine="scan", **kw)
    return jax.jit(solve)(mu0, sigma0)[1]


@pytest.mark.parametrize("cfg", list(MAIN_PATHS))
def test_main_path_reference_traces_decrease(cfg):
    """The JAX solver's trace at each main-path configuration is finite and
    decreasing, so the card's run must give a non-increasing one."""
    trace = _jax_main_path_trace(cfg)
    assert trace.shape == (3,) and np.isfinite(trace).all() and (np.diff(trace) < 0).all()


@reference(__file__)
def _jax_batch():
    name, env_kw, T, kw = _kw("lr-bisect")
    jenv = _envs(name, env_kw)[0]
    key = jax.random.PRNGKey(4)
    out = jax_rgps.run_rgps_batch(jenv, key, 3, T, fp_engine="scan", **kw)
    mu0 = jnp.asarray(np.asarray(jenv.init()[0]))
    mu0s = mu0 + 0.1 * jax.vmap(lambda k: jax.random.normal(k, mu0.shape, mu0.dtype))(
        jax.random.split(key, 3))
    return out, mu0s


def test_run_rgps_batch_matches_jax():
    """Three perturbed problems in one batched solve, each instance with its
    own β bracket and its own fixed points (one group per instance)."""
    name, env_kw, T, kw = _kw("lr-bisect")
    env = _envs(name, env_kw)[1]
    want, mu0s = _jax_batch()
    got = port.run_rgps_batch(env, None, 3, T, fp_engine="cuda", mu0s=torch.as_tensor(mu0s),
                              **kw, **F64)
    for k in ("trace", "K", "kff", "sigma"):
        np.testing.assert_allclose(got[k].numpy(), want[k], err_msg=k, **TOL)
    draws, sigma0s = port.rgps_batch_initial_states(env, torch.Generator().manual_seed(0), 3,
                                                    **F64)
    assert draws.shape == (3, 2) and sigma0s.shape == (3, 2, 2)


@reference(__file__)
def _jax_warm():
    """JAX's state after one iteration and after two (mb on Pendulum)."""
    name, env_kw, T, kw = _kw("mb-pendulum")
    jenv = _envs(name, env_kw)[0]
    mu0, sigma0 = (jnp.asarray(np.asarray(a)) for a in jenv.init())
    outs = []
    for it in (1, 2):
        solve = jax_rgps.make_rgps_solver(jenv, T, fp_engine="scan", **dict(kw, nb_iter=it))
        outs.append(_state_dict(jax.jit(solve)(mu0, sigma0)[0]))
    return outs


def test_jax_state_continues_in_the_port():
    name, env_kw, T, kw = _kw("mb-pendulum")
    env = _envs(name, env_kw)[1]
    state1, state2 = _jax_warm()
    port_state = rgps_state_from_numpy(state1, device="cpu")
    assert isinstance(port_state, port.RGPSState) and port_state.ctl.K.shape == (T, 1, 2)
    back = rgps_state_to_numpy(port_state)
    for k, v in back.items():
        for f, a in (v.items() if isinstance(v, dict) else [(None, v)]):
            np.testing.assert_array_equal(a, state1[k][f] if f else state1[k])
    solve = port.make_rgps_solver(env, T, fp_engine="cuda", **kw, **F64)
    nxt = solve.iteration(port_state)
    got = rgps_state_to_numpy(nxt)
    for name in ("ctl", "nominal"):
        for f, w in state2[name].items():
            np.testing.assert_allclose(got[name][f], w, err_msg=f"{name}.{f}", **TOL)
    np.testing.assert_allclose(got["last_return"], state2["last_return"], **TOL)
    nominal = matrix_normal_from_numpy(state1["nominal"], device="cpu")
    for f, a in matrix_normal_to_numpy(nominal).items():
        np.testing.assert_array_equal(a, state1["nominal"][f])


def test_unported_and_invalid_options_raise():
    env = trajopt_torch.make("LQR-TO-v1")
    with pytest.raises(NotImplementedError, match="row 13"):
        port.make_rgps_solver(env, 6, variant="mf", **F64)
    with pytest.raises(NotImplementedError, match="row 15"):
        port.make_rgps_solver(env, 6, differentiable=True, **F64)
    with pytest.raises(NotImplementedError, match="row 17"):
        port.run_rgps_batch(env, None, 2, 6, mesh=object(), **F64)
    for bad in (dict(fp_engine="pallas"), dict(variant="x"), dict(interp="x"),
                dict(beta_search="x"), dict(alpha_search="x"),
                dict(fp_engine="cuda", interp="w2")):
        with pytest.raises(ValueError):
            port.make_rgps_solver(env, 6, **bad, **F64)
    assert port.make_rgps_solver(env, 6, interp="w2", **F64).batched.fp_engine == "scan"
    assert port.make_rgps_solver(env, 6, **F64).batched.fp_engine == "scan"   # auto, CPU
    # the upper β bracket: 1e64 where the dtype holds 1e65, else 1e30
    assert port._big(torch.float64) == 1e64 and port._big(torch.float32) == 1e30
    solve = port.make_rgps_solver(env, 6, **F64)
    with pytest.raises(ValueError, match="built for"):
        solve(torch.zeros(2, dtype=torch.float32), torch.eye(2, dtype=torch.float32))
