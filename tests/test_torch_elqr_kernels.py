"""The plain versions of the eLQR kernels K11–K14 and the batched solver's
engines against trajopt_tpu's scan sweeps, float64 on the CPU.

On Cartpole-TO-v0 (from the hanging start, as tests/test_pallas_elqr.py) and
Cartpole-TO-v1 (from near upright: from the hanging start its first forward
sweep meets a singular goV + comeV and the reference's trace turns NaN), N=3,
T=8: the port's scan sweeps (``solvers/elqr``) and the plain versions of K11,
K12 and K13 (``core/cuda_elqr``, which run for CPU tensors) against JAX's
``elqr_forward_lqr`` / ``elqr_backward_lqr`` / ``elqr_rollout`` on the
second iteration's operands, JAX's first iteration carried across with
``utils/convert``; the batched solver's ``cuda`` (K11–K13) and
``cuda-fused`` (K14) engines against JAX's ``engine="scan"`` over 3
iterations at rtol 1e-7 / atol 1e-8, the tolerance tests/test_pallas_elqr.py
holds the Pallas engines to (JAX's scan engine vmaps ``make_elqr_solver``,
whose loop body runs here on each instance); ``engine="auto"``'s choice;
the engines' calls of the wrappers and the launch counters.  Each JAX
reference is compiled once for one instance.

Not run here: the interpret-mode Pallas eLQR kernels.  One call of those
costs 15–36 s on a CPU even at T=4 with one iteration, and
tests/test_pallas_elqr.py already holds them to the scan engine this file
holds the plain versions to.  The JAX references are frozen
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
from trajopt_torch.core import cuda_elqr
from trajopt_torch.core.cuda_lqr import to_soa
from trajopt_torch.parallel import elqr as port_par
from trajopt_torch.solvers import elqr as port
from trajopt_torch.utils.convert import (
    env_from_fields,
    linear_policy_from_numpy,
    linear_policy_to_numpy,
    quadratic_value_from_numpy,
    quadratic_value_to_numpy,
)
from trajopt_tpu.core.types import LinearPolicy as JaxPolicy
from trajopt_tpu.core.types import QuadraticValue as JaxValue
from trajopt_tpu.solvers import elqr as jax_elqr

from make_torch_refs import reference

torch.set_num_threads(1)

N, T, ITERS = 3, 8, 3
TOL = dict(rtol=1e-7, atol=1e-8)
X0 = {"Cartpole-TO-v0": np.pi, "Cartpole-TO-v1": 0.3}
F64 = dict(device="cpu", dtype=torch.float64)


def _compiled(f, *args):
    """``jax.jit(f)`` compiled for ``args`` without XLA's backend (LLVM)
    optimizations and its fusion pass: about half the compile time, rounding
    that differs from the default compile's at the 1e-14 level."""
    return jax.jit(f).lower(*args).compile(
        {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True,
         "xla_disable_hlo_passes": "fusion"})


def _envs(name):
    jenv = trajopt_tpu.make(name)
    return jenv, env_from_fields(name, dataclasses.asdict(jenv))


def _x0s(name):
    x0s = np.zeros((N, 4))
    x0s[:, 1] = X0[name] + 0.02 * np.arange(N)
    return x0s


class _PerInstance:
    """``f`` compiled once for one instance and run on each of the N, the
    outputs stacked: ``jax.vmap``'s result at a fraction of its compile
    time."""

    def __init__(self, f, *args):
        self.compiled = _compiled(f, *jax.tree.map(lambda a: a[0], args))

    def __call__(self, *args):
        outs = [self.compiled(*jax.tree.map(lambda a: a[i], args)) for i in range(N)]
        return jax.tree.map(lambda *x: jnp.stack(x), *outs)


@functools.lru_cache(maxsize=None)
@reference(__file__)
def _jax_results():
    """Per env, JAX's iteration (the body of ``make_elqr_solver``'s loop:
    forward sweep, backward sweep, rollout) compiled once: the first from K
    = 0 and kff0 gives the iterate, the second the sweeps the tests hold the
    port to; for v0 a third gives JAX's scan-engine solve (with the rollout
    of the initial controller for the first return)."""
    keys = jax.random.split(jax.random.PRNGKey(0), N)
    kff0 = jax.vmap(lambda k: jax.random.normal(jax.random.split(k)[0], (T, 1)))(keys)
    ctl0 = JaxPolicy(K=jnp.zeros((N, T, 1, 4)), kff=kff0)
    V = jnp.zeros((N, T + 1, 4, 4)).at[:, 0].add(1e-16 * jnp.eye(4))
    go0 = JaxValue(V=V, v=jnp.zeros((N, T + 1, 4)), v0=jnp.zeros((N, T + 1)))
    out = {}
    for name in X0:
        env = _envs(name)[0]
        x0 = jnp.asarray(_x0s(name))

        def iteration(x0, state, ctl, goV, gov, env=env):
            fwd = jax_elqr.elqr_forward_lqr(env, state, ctl, goV, gov)
            bwd = jax_elqr.elqr_backward_lqr(env, fwd[0], fwd[1], *fwd[2])
            return fwd, bwd, jax_elqr.elqr_rollout(env, bwd[1], x0)

        run = _PerInstance(iteration, x0, x0, ctl0, go0.V, go0.v)
        its = [run(x0, x0, ctl0, go0.V, go0.v)]
        for _ in range(ITERS - 1):
            state, ctl, go = its[-1][1]
            its.append(run(x0, state, ctl, go.V, go.v))
        out[name] = jax.tree.map(np.asarray, (its[0][1], *its[1]))
        if name == "Cartpole-TO-v0":
            roll0 = _PerInstance(functools.partial(jax_elqr.elqr_rollout, env), ctl0, x0)
            trace = [roll0(ctl0, x0)[2].sum(-1)] + [it[2][2].sum(-1) for it in its]
            xs, us, _ = its[-1][2]
            solved = (its[-1][1][1], xs, us, jnp.stack(trace, -1))
    return out, jax.tree.map(np.asarray, solved), np.asarray(kff0)


def _t(a):
    return torch.as_tensor(np.array(a))


def _soa(a):
    return to_soa(_t(a), N)


def _lanes(a):
    """(N, d) → (d, N)."""
    return _t(a).T.contiguous()


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **TOL)


@pytest.mark.parametrize("name", list(X0))
def test_scan_sweeps_match_jax_from_a_jax_iterate(name):
    """The port's scan sweeps of the second iteration, batched over the N
    instances, from JAX's first-iteration state, controller and cost-to-go."""
    (state, ctl, go), fwd, bwd, roll = _jax_results()[0][name]
    env = _envs(name)[1]
    ctl_t = linear_policy_from_numpy(ctl._asdict(), device="cpu")
    go_t = quadratic_value_from_numpy(go._asdict(), device="cpu")
    s1, ictl, come = port.elqr_forward_lqr(env, _t(state), ctl_t, go_t.V, go_t.v)
    _close(s1, fwd[0])
    for k, w in linear_policy_to_numpy(ictl).items():
        _close(w, getattr(fwd[1], k))
    for k, w in quadratic_value_to_numpy(come).items():
        _close(w, getattr(fwd[2], k))
    s2, ctl2, go2 = port.elqr_backward_lqr(
        env, _t(fwd[0]), linear_policy_from_numpy(fwd[1]._asdict(), device="cpu"),
        *quadratic_value_from_numpy(fwd[2]._asdict(), device="cpu"))
    _close(s2, bwd[0])
    for k, w in linear_policy_to_numpy(ctl2).items():
        _close(w, getattr(bwd[1], k))
    for k, w in quadratic_value_to_numpy(go2).items():
        _close(w, getattr(bwd[2], k))
    out = port.elqr_rollout(env, linear_policy_from_numpy(bwd[1]._asdict(), device="cpu"),
                            _t(_x0s(name)))
    for got, w in zip(out, roll):
        _close(got, w)


@pytest.mark.parametrize("name", list(X0))
def test_sweep_kernels_plain_match_jax(name):
    """K11, K12 and K13's plain versions on the kernels' streams, each from
    the JAX outputs that precede it in the second iteration."""
    (state, ctl, go), fwd, bwd, roll = _jax_results()[0][name]
    env = _envs(name)[1]
    iK, ikff, comeV, comev, comev0, x_mid = cuda_elqr.cuda_elqr_forward(
        env, _soa(ctl.K), _soa(ctl.kff), _soa(go.V), _soa(go.v), _lanes(state))
    _close(x_mid.T, fwd[0])
    for got, w in ((iK, fwd[1].K), (ikff, fwd[1].kff), (comeV, fwd[2].V), (comev, fwd[2].v),
                   (comev0, fwd[2].v0)):
        _close(got, _soa(w))
    K, kff, goV, gov, gov0, x_out = cuda_elqr.cuda_elqr_backward(
        env, _soa(fwd[1].K), _soa(fwd[1].kff), _soa(fwd[2].V), _soa(fwd[2].v), _lanes(fwd[0]))
    _close(x_out.T, bwd[0])
    for got, w in ((K, bwd[1].K), (kff, bwd[1].kff), (goV, bwd[2].V), (gov, bwd[2].v),
                   (gov0, bwd[2].v0)):
        _close(got, _soa(w))
    x0 = _lanes(_x0s(name))
    ret = cuda_elqr.cuda_elqr_rollout(env, _soa(bwd[1].K), _soa(bwd[1].kff), x0)
    _close(ret, roll[2].sum(-1))
    ret2, xs, us = cuda_elqr.cuda_elqr_rollout(env, _soa(bwd[1].K), _soa(bwd[1].kff), x0,
                                               store=True)
    assert torch.equal(ret, ret2)
    _close(xs, _soa(roll[0]))
    _close(us, _soa(roll[1]))


@pytest.mark.parametrize("engine", ["cuda", "cuda-fused"])
def test_kernel_engines_plain_match_jax_scan(engine):
    """The batched solver's kernel engines (the plain versions of K11–K13,
    and of K14) against JAX's scan engine on Cartpole-TO-v0."""
    _, (ctl, xs, us, trace), kff0 = _jax_results()
    env = _envs("Cartpole-TO-v0")[1]
    solve = port_par.make_elqr_solver_batched(env, T, ITERS, engine=engine, **F64)
    got = solve(_t(_x0s("Cartpole-TO-v0")), kff_init=_t(kff0))
    for g, w in zip((got[0].K, got[0].kff, *got[1:]), (ctl.K, ctl.kff, xs, us, trace)):
        _close(g, w)


def test_auto_engine_choice():
    cart = trajopt_torch.make("Cartpole-TO-v0")
    pick = port_par.pick_engine
    assert pick(cart, 64, "cuda") == "cuda-fused"
    assert pick(cart, 128, "cuda:0") == "cuda-fused"
    assert pick(cart, 129, "cuda") == "cuda"
    assert pick(trajopt_torch.make("Cartpole-TO-v1"), 1024, "cuda") == "cuda"
    assert pick(cart, 64, "cpu") == "scan"
    pend = trajopt_torch.make("Pendulum-TO-v0")
    assert pick(pend, 64, "cuda") == "cuda-fused"
    assert pick(trajopt_torch.make("Pendulum-TO-v1"), 1024, "cuda") == "cuda"
    assert pick(pend, 64, "cpu") == "scan"
    for env in (trajopt_torch.make("LQR-TO-v0"), cart.replace(slew_rate=True),
                pend.replace(slew_rate=True)):
        assert pick(env, 64, "cuda") == "scan"


def test_engines_call_the_wrappers_and_count_no_plain_run(monkeypatch):
    """The streamed engine calls K11 and K12 once per iteration and K13
    nb_iter + 2 times (initial, per iteration, final stored); the fused one
    calls K14 once.  On CPU tensors the wrappers run their plain versions,
    which are not launches: the counters stay at zero."""
    env = trajopt_torch.make("Cartpole-TO-v0")
    wrappers = ("cuda_elqr_forward", "cuda_elqr_backward", "cuda_elqr_rollout",
                "cuda_elqr_solve")
    for w in wrappers:
        getattr(cuda_elqr, w).launches = 0
    calls = dict.fromkeys(wrappers, 0)

    def counted(name):
        inner = getattr(cuda_elqr, name)

        def call(*args, **kw):
            calls[name] += 1
            return inner(*args, **kw)
        return call

    for w in wrappers:
        monkeypatch.setattr(cuda_elqr, w, counted(w))
    x0s = torch.tensor(_x0s("Cartpole-TO-v0"))
    kff0 = torch.zeros(N, 4, 1, dtype=torch.float64)
    port_par.make_elqr_solver_batched(env, 4, 2, engine="cuda", **F64)(x0s, kff_init=kff0)
    assert calls == {"cuda_elqr_forward": 2, "cuda_elqr_backward": 2, "cuda_elqr_rollout": 4,
                     "cuda_elqr_solve": 0}
    port_par.make_elqr_solver_batched(env, 4, 2, engine="cuda-fused", **F64)(x0s, kff_init=kff0)
    assert calls["cuda_elqr_solve"] == 1 and calls["cuda_elqr_forward"] == 2
    monkeypatch.undo()
    assert all(getattr(cuda_elqr, w).launches == 0 for w in wrappers)
