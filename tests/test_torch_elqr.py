"""The port's eLQR against trajopt_tpu's, float64 on the CPU.

``inverse_dynamics`` (and the ``rk4_backward`` under it) on Cartpole v0/v1,
Pendulum-TO-v0 and LQR-TO-v0, with its Jacobians at the action bound and the
cart bound (jnp.clip's ½ tie), and ``quadratize_cost_elqr`` at rtol 1e-10;
``make_elqr_solver`` on Cartpole-TO-v0 (T=8, 3
iterations) and Pendulum-TO-v0 (dt=0.05, T=6, 2 iterations) at rtol 1e-8,
the kernel engines' plain versions on the latter too;
the host ``eLQR`` on LQR-TO-v0 (T=20, 5 iterations); the raises.  The
initial feedforward is JAX's draw, handed to the port as ``kff_init``.
Where eLQR re-chooses the state at the goal, kff is rounding residue (of
order 1e-54), held by the absolute part of the tolerance.  The JAX
references are compiled once, as one program, and frozen
(``tests/make_torch_refs.py``)."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import trajopt_torch
import trajopt_tpu
from trajopt_torch.core.diff import quadratize_cost_elqr
from trajopt_torch.envs.base import rk4_backward
from trajopt_torch.parallel.elqr import make_elqr_solver, make_elqr_solver_batched
from trajopt_torch.solvers import elqr as port
from trajopt_torch.utils.convert import env_from_fields
from trajopt_tpu.core import diff as jax_diff
from trajopt_tpu.envs import base as jax_base
from trajopt_tpu.parallel import elqr as jax_par
from trajopt_tpu.solvers import elqr as jax_elqr

from make_torch_refs import reference

torch.set_num_threads(1)

TOL = dict(rtol=1e-8, atol=1e-10)
ENV_IDS = ["Cartpole-TO-v0", "Cartpole-TO-v1", "Pendulum-TO-v0", "LQR-TO-v0"]
CARTPOLE = ("Cartpole-TO-v0", 8, 3, {})
PENDULUM = ("Pendulum-TO-v0", 6, 2, {"dt": 0.05})


def _compiled(f, *args):
    """``jax.jit(f)`` compiled for ``args`` without XLA's backend (LLVM)
    optimizations and its fusion pass: about half the compile time, rounding
    that differs from the default compile's at the 1e-14 level."""
    return jax.jit(f).lower(*args).compile(
        {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True,
         "xla_disable_hlo_passes": "fusion"})


def _envs(name, **kw):
    jenv = trajopt_tpu.make(name, **kw)
    return jenv, env_from_fields(name, dataclasses.asdict(jenv))


def _t(a):
    return torch.as_tensor(np.array(a))


def _points(env, n, seed):
    """Seeded (x, u), some actions exactly at ±umax."""
    rng = np.random.default_rng(seed)
    x = np.asarray(env.x0) + 0.5 * rng.standard_normal((n, env.dm_state))
    u = 3.0 * rng.standard_normal((n, env.dm_act))
    umax = np.asarray(env.umax, dtype=float)
    if np.isfinite(umax).all():
        u[0], u[1] = umax, -umax
    return x, u


def _inverse_points(name):
    jenv = trajopt_tpu.make(name)
    x, u = _points(jenv, 5, 0)
    if name.startswith("Cartpole"):
        x[2, 0] = 9.999          # lands past the cart bound xmax[0] = 10 ...
        x[3, 0] = 10.0           # ... or starts on it
    return x, u


@functools.lru_cache(maxsize=None)
@reference(__file__)
def _jax_points():
    """One program: per env, the inverse dynamics, its backward RK4 and its
    Jacobians at ``_inverse_points``, and the quadratization at ``_points``."""
    envs = [trajopt_tpu.make(n) for n in ENV_IDS]
    args = [(*_inverse_points(n), *_points(e, 4, 1)) for n, e in zip(ENV_IDS, envs)]

    def program(args):
        out = []
        for env, (x, u, xq, uq) in zip(envs, args):
            f = env.inverse_dynamics
            back = jax.vmap(lambda x, u: jax_base.rk4_backward(env._ode, x, u, env.dt))(x, u) \
                if hasattr(env, "_ode_parts") and env.supports_tiles else f(x[0], u[0])
            out.append((jax.vmap(f)(x, u), back,
                        jax.vmap(jax.jacfwd(f, argnums=0))(x, u),
                        jax.vmap(jax.jacfwd(f, argnums=1))(x, u),
                        jax.vmap(lambda x, u: jax_diff.quadratize_cost_elqr(env.cost, x, u))(
                            xq, uq)))
        return out

    return dict(zip(ENV_IDS, jax.tree.map(np.asarray, _compiled(program, args)(args))))


@pytest.mark.parametrize("name", ENV_IDS)
def test_inverse_dynamics_matches_jax(name):
    env = _envs(name)[1]
    x, u = (_t(a) for a in _inverse_points(name))
    want, back, jac_x, jac_u, _ = _jax_points()[name]
    tol = dict(rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(env.inverse_dynamics(x, u).numpy(), want, **tol)
    if name != "LQR-TO-v0":
        np.testing.assert_allclose(rk4_backward(env._ode, x, u, env.dt).numpy(), back, **tol)
    for argnum, jj in ((0, jac_x), (1, jac_u)):
        tj = torch.func.vmap(torch.func.jacfwd(env.inverse_dynamics, argnums=argnum))(x, u)
        np.testing.assert_allclose(tj.numpy(), jj, **tol)


@pytest.mark.parametrize("name", ENV_IDS)
def test_quadratize_cost_elqr_matches_jax(name):
    jenv, env = _envs(name)
    x, u = _points(jenv, 4, 1)
    got = quadratize_cost_elqr(env.cost, _t(x), _t(u))
    for g, w in zip(got, _jax_points()[name][4]):
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-10, atol=1e-10)


def _kff0(key, T, du):
    return jax.random.normal(jax.random.split(key)[0], (T, du), jnp.float64)


@functools.lru_cache(maxsize=None)
@reference(__file__)
def _jax_results():
    """One program: the two single-problem solves and their initial kff."""
    cfgs = [CARTPOLE, PENDULUM]
    solvers = [jax_par.make_elqr_solver(_envs(n, **kw)[0], T, nb_iter=it)
               for n, T, it, kw in cfgs]

    def program(key, x0s):
        return [(s(key, x0), _kff0(key, c[1], 1)) for s, c, x0 in zip(solvers, cfgs, x0s)]

    key = jax.random.PRNGKey(3)
    x0s = [jnp.asarray(np.asarray(_envs(n, **kw)[0].x0, dtype=float)) + 0.05
           for n, _, _, kw in cfgs]
    out = _compiled(program, key, x0s)(key, x0s)
    return jax.tree.map(np.asarray, out), [np.asarray(x) for x in x0s]


def _check_policy(ctl, want):
    np.testing.assert_allclose(ctl.K.numpy(), want.K, **TOL)
    np.testing.assert_allclose(ctl.kff.numpy(), want.kff, **TOL)


@pytest.mark.parametrize("cfg", [CARTPOLE, PENDULUM], ids=["cartpole", "pendulum"])
def test_make_elqr_solver_matches_jax(cfg):
    solves, x0s = _jax_results()
    i = [CARTPOLE, PENDULUM].index(cfg)
    name, T, it, kw = cfg
    (want, kff0), x0 = solves[i], x0s[i]
    solve = make_elqr_solver(_envs(name, **kw)[1], T, nb_iter=it, device="cpu",
                             dtype=torch.float64)
    ctl, xs, us, trace = solve(_t(x0), kff_init=_t(kff0))
    _check_policy(ctl, want[0])
    for got, w in zip((xs, us, trace), want[1:]):
        np.testing.assert_allclose(got.numpy(), w, **TOL)


@pytest.mark.parametrize("engine", ["cuda", "cuda-fused"])
def test_kernel_engines_plain_match_jax_on_pendulum(engine):
    """The kernel engines on Pendulum-TO-v0 (their device functions in
    csrc/envs.cuh) run K11-K13's and K14's plain versions on CPU tensors;
    they agree with JAX's solve of the pendulum case above."""
    solves, x0s = _jax_results()
    name, T, it, kw = PENDULUM
    (want, kff0), x0 = solves[1], x0s[1]
    solve = make_elqr_solver_batched(_envs(name, **kw)[1], T, it, engine=engine, device="cpu",
                                     dtype=torch.float64)
    ctl, xs, us, trace = solve(_t(x0)[None], kff_init=_t(kff0)[None])
    np.testing.assert_allclose(ctl.K[0].numpy(), want[0].K, **TOL)
    np.testing.assert_allclose(ctl.kff[0].numpy(), want[0].kff, **TOL)
    for got, w in zip((xs[0], us[0], trace[0]), want[1:]):
        np.testing.assert_allclose(got.numpy(), w, **TOL)


@reference(__file__)
def _jax_host(T, it):
    """The host eLQR on LQR-TO-v0: trace, final reference, controller, kff0."""
    jenv = _envs("LQR-TO-v0")[0]
    key = jax.random.PRNGKey(0)
    jsolver = jax_elqr.eLQR(jenv, T, init_state=np.asarray(jenv.x0, dtype=float), key=key)
    want = jsolver.run(nb_iter=it)
    return dict(trace=want, xref=jsolver.xref, uref=jsolver.uref, ctl=jsolver.ctl,
                kff0=_kff0(key, T, 1))


def test_host_elqr_matches_jax_on_lqr():
    env = _envs("LQR-TO-v0")[1]
    T, it = 20, 5
    ref = _jax_host(T, it)
    solver = port.eLQR(env, T, np.asarray(env.x0, dtype=float), kff_init=_t(ref["kff0"]),
                       device="cpu", dtype=torch.float64)
    trace = solver.run(nb_iter=it)
    np.testing.assert_allclose(trace, ref["trace"], **TOL)
    np.testing.assert_allclose(solver.xref.numpy(), ref["xref"], **TOL)
    np.testing.assert_allclose(solver.uref.numpy(), ref["uref"], **TOL)
    _check_policy(solver.ctl, ref["ctl"])
    assert trace[-1] < trace[0]
    with pytest.raises(NotImplementedError, match="row 16"):
        solver.plot()


def test_raises():
    cart = trajopt_torch.make("Cartpole-TO-v0")
    with pytest.raises(NotImplementedError, match="row 17"):
        make_elqr_solver_batched(cart, 8, mesh=object(), device="cpu")
    with pytest.raises(ValueError, match="unknown engine"):
        make_elqr_solver_batched(cart, 8, engine="pallas", device="cpu")
    for engine in ("cuda", "cuda-fused"):
        with pytest.raises(ValueError):
            make_elqr_solver_batched(trajopt_torch.make("LQR-TO-v0"), 8, engine=engine,
                                     device="cpu")
        make_elqr_solver_batched(trajopt_torch.make("Pendulum-TO-v0"), 8, engine=engine,
                                 device="cpu")
    with pytest.raises(ValueError, match="slew"):
        make_elqr_solver_batched(cart.replace(slew_rate=True), 8, engine="cuda", device="cpu")
    lqr = trajopt_torch.make("LQR-TO-v1")
    with pytest.raises(NotImplementedError, match="row 13"):
        lqr.dynamics_dist()
    solve = make_elqr_solver_batched(cart, 8, engine="scan", device="cpu", dtype=torch.float64)
    with pytest.raises(ValueError, match="built for"):
        solve(torch.zeros(2, 4, dtype=torch.float32))
