"""The port's single-problem iLQR against trajopt_tpu's, float64 on the CPU.

``make_ilqr_solver`` on Pendulum-TO-v0 (dt=0.05, uw=1e-5, T=16, 5
iterations): the ``scan`` and ``pscan`` engines against JAX's, and
``cuda-pscan`` (K5's plain version on CPU tensors) against JAX's ``pscan``,
since JAX's ``pallas-pscan`` has no CPU route inside the solver.  Also: the
unported options raise, and ``utils/convert`` carries Pendulum and an
unbatched state across.  The MPC drivers built on this solver are held to
JAX's in test_torch_mpc_runner.py.  Each JAX reference is compiled once per
module."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import trajopt_tpu
from trajopt_torch.parallel import mpc as port
from trajopt_torch.utils.convert import (
    env_from_fields,
    ilqr_state_from_numpy,
    ilqr_state_to_numpy,
)
from trajopt_tpu.parallel import mpc as jax_mpc

torch.set_num_threads(1)

T, NB_ITER = 16, 5
TOL = dict(rtol=1e-7, atol=1e-9)
F64 = dict(device="cpu", dtype=torch.float64)


def _compiled(f, *args):
    """``jax.jit(f)`` compiled for ``args`` without XLA's backend (LLVM)
    optimizations: a shorter compile, rounding that differs from the default
    compile's at the 1e-14 level."""
    return jax.jit(f).lower(*args).compile(
        {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True})


def _as_np(state):
    return {k: np.asarray(v) for k, v in state._asdict().items()}


@pytest.fixture(scope="module")
def ref():
    jenv = trajopt_tpu.make("Pendulum-TO-v0", dt=0.05).replace(uw=(1e-5,))
    x0 = np.asarray(jenv.x0)
    engines = ("scan", "pscan")
    solvers = [jax_mpc.make_ilqr_solver(jenv, T, nb_iter=NB_ITER, backward=eng)
               for eng in engines]
    # one program for both engines: one compile instead of two
    x0j = jnp.asarray(x0)
    outs = _compiled(lambda x: [solve(x) for solve in solvers], x0j)(x0j)
    solves = {eng: (_as_np(state), np.asarray(trace))
              for eng, (state, trace) in zip(engines, outs)}

    return dict(
        jenv=jenv, env=env_from_fields("Pendulum-TO-v0", dataclasses.asdict(jenv)), x0=x0,
        solves=solves,
    )


@pytest.mark.parametrize("backward,jax_backward",
                         [("scan", "scan"), ("pscan", "pscan"), ("cuda-pscan", "pscan")])
def test_solver_matches_jax(ref, backward, jax_backward):
    from trajopt_torch.core.cuda_pscan import cuda_pilqr_backward

    solve = port.make_ilqr_solver(ref["env"], T, nb_iter=NB_ITER, backward=backward, **F64)
    state, trace = solve(torch.as_tensor(ref["x0"]))
    jstate, jtrace = ref["solves"][jax_backward]
    assert state.uref.shape == (T, 1) and state.lmbda.shape == ()
    np.testing.assert_allclose(state.last_return.numpy(), jstate["last_return"], **TOL)
    np.testing.assert_allclose(state.uref.numpy(), jstate["uref"], **TOL)
    np.testing.assert_allclose(trace.numpy(), jtrace, **TOL)
    assert bool(state.done) == bool(jstate["done"])
    # the swing-up improves on the initial trajectory; plain runs count no launch
    assert trace[-1] < trace[0]
    assert cuda_pilqr_backward.launches == 0


def test_solver_metrics_trace(ref):
    solve = port.make_ilqr_solver(ref["env"], T, nb_iter=2, metrics=True, **F64)
    _, m = solve(torch.as_tensor(ref["x0"]))
    assert m.ret.shape == m.lmbda.shape == m.dlmbda.shape == m.done.shape == (2,)
    np.testing.assert_allclose(m.ret.numpy(), ref["solves"]["scan"][1][:2], **TOL)


def test_unported_options_raise(ref):
    env = ref["env"]
    with pytest.raises(NotImplementedError, match="row 17"):
        port.make_ilqr_solver(env, 8, time_mesh=object(), **F64)
    with pytest.raises(ValueError, match="backward"):
        port.make_ilqr_solver(env, 8, backward="pallas-pscan", **F64)
    solve = port.make_ilqr_solver(env, 8, **F64)
    with pytest.raises(ValueError, match="built for"):
        solve(torch.zeros(2, dtype=torch.float32))


def test_convert_carries_pendulum_and_an_unbatched_state(ref):
    jenv = ref["jenv"]
    env = env_from_fields("Pendulum-TO-v1", dataclasses.asdict(
        trajopt_tpu.make("Pendulum-TO-v1", dt=0.02, umax=(2.0,))))
    assert (env.dt, env.umax, env.xmax) == (0.02, (2.0,), (float("inf"), float("inf")))
    assert dataclasses.asdict(ref["env"]) == dataclasses.asdict(jenv)

    jstate = ref["solves"]["scan"][0]
    state = ilqr_state_from_numpy(jstate, device="cpu")
    assert state.done.dtype == torch.bool and state.done.shape == ()
    assert state.xref.shape == (T + 1, 2) and state.lmbda.shape == ()
    for k, v in ilqr_state_to_numpy(state).items():
        np.testing.assert_array_equal(v, jstate[k])
