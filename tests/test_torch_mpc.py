"""The port's batched iLQR slice against trajopt_tpu's, float64 on the CPU.

Cartpole swing-up (actions saturate at ±umax), T=40, N=8, 3 iterations: the
port's ``make_ilqr_solver_batched`` on every engine pair — scan, and the kernel
engines, whose wrappers run their plain versions on CPU tensors — against JAX's
``backward="scan", rollout="scan"``.  Also: a warm start handed across with
``utils/convert``, the import isolation of the port, and its precision pin.
The JAX solves are frozen (``tests/make_torch_refs.py``)."""

import dataclasses
import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import trajopt_torch
import trajopt_tpu
from trajopt_torch.parallel.mpc import make_ilqr_solver_batched
from trajopt_torch.utils.convert import (
    env_from_fields,
    ilqr_state_from_numpy,
    ilqr_state_to_numpy,
)
from trajopt_tpu.parallel.mpc import make_ilqr_solver_batched as jax_solver

from make_torch_refs import frozen

torch.set_num_threads(1)

N, T, NB_ITER = 8, 40, 3
TOL = dict(rtol=1e-8, atol=1e-10)
FIELDS = ("xref", "uref", "K", "kff", "lmbda", "last_return")


def _compiled(f, *args):
    """``jax.jit(f)`` compiled for ``args`` without XLA's backend (LLVM)
    optimizations and its fusion pass: about half the compile time, rounding
    that differs from the default compile's at the 1e-14 level."""
    return jax.jit(f).lower(*args).compile(
        {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True,
         "xla_disable_hlo_passes": "fusion"})


@pytest.fixture(scope="module")
def problem():
    jenv = trajopt_tpu.make("Cartpole-TO-v0")
    rng = np.random.default_rng(0)
    x0s = np.asarray(jenv.x0) + 0.05 * rng.standard_normal((N, jenv.dm_state))
    jsolve2 = jax_solver(jenv, T, nb_iter=NB_ITER - 1, backward="scan", rollout="scan")
    jsolve3 = jax_solver(jenv, T, nb_iter=NB_ITER, backward="scan", rollout="scan")
    # one program for both: one compile instead of two
    x0j = jnp.asarray(x0s)
    (state3, trace3), (state2, _) = frozen(__file__, "solves", lambda: _compiled(
        lambda x: (jsolve3(x), jsolve2(x)), x0j)(x0j))
    as_np = lambda s: {k: np.asarray(v) for k, v in s._asdict().items()}  # noqa: E731
    return dict(
        env=env_from_fields("Cartpole-TO-v0", dataclasses.asdict(jenv)),
        x0s=x0s, state2=as_np(state2), state3=as_np(state3), trace3=np.asarray(trace3),
    )


def _assert_state_matches(state, ref):
    for k in FIELDS:
        np.testing.assert_allclose(getattr(state, k).numpy(), ref[k], err_msg=k, **TOL)
    np.testing.assert_array_equal(state.done.numpy(), ref["done"])


@pytest.mark.parametrize(
    "backward,rollout", [("scan", "scan"), ("cuda-fused", "cuda"), ("cuda", "scan")]
)
def test_slice_matches_jax(problem, backward, rollout):
    solve = make_ilqr_solver_batched(
        problem["env"], T, nb_iter=NB_ITER, backward=backward, rollout=rollout,
        time_chunk=8, device="cpu", dtype=torch.float64,
    )
    state, trace = solve(torch.as_tensor(problem["x0s"]))
    ref = problem["state3"]
    # a swing-up: the accepted trajectories push the cart at its force limit
    assert np.any(np.abs(ref["uref"]) == 10.0)
    _assert_state_matches(state, ref)
    np.testing.assert_allclose(trace.numpy(), problem["trace3"], **TOL)


def test_warm_start_through_convert(problem):
    """JAX's state after two iterations, carried over as numpy, continues in
    the port for one iteration and lands on JAX's three-iteration state."""
    solve = make_ilqr_solver_batched(
        problem["env"], T, nb_iter=NB_ITER, backward="cuda-fused", rollout="cuda",
        metrics=True, device="cpu", dtype=torch.float64,
    )
    state2 = ilqr_state_from_numpy(problem["state2"], device="cpu")
    assert state2.done.dtype == torch.bool
    round_trip = ilqr_state_to_numpy(state2)
    for k, v in problem["state2"].items():
        np.testing.assert_array_equal(round_trip[k], v)
    state3, metrics = solve.iteration(state2)
    _assert_state_matches(state3, problem["state3"])
    np.testing.assert_array_equal(metrics.done.numpy(), problem["state3"]["done"])


def test_solver_rejects_unported_options():
    env = trajopt_torch.make("Cartpole-TO-v0")
    for kw in ({"fast_line_search": True}, {"differentiable": True}):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            make_ilqr_solver_batched(env, 8, device="cpu", **kw)
    with pytest.raises(ValueError, match="backward"):
        make_ilqr_solver_batched(env, 8, backward="pallas", device="cpu")
    solve = make_ilqr_solver_batched(env, 8, device="cpu", dtype=torch.float64)
    with pytest.raises(ValueError, match="built for"):
        solve(torch.zeros(2, 4, dtype=torch.float32))


def test_port_imports_neither_jax_nor_reference():
    """Importing every module of the port with ``jax`` and ``trajopt_tpu``
    made unimportable must succeed, and no port source names either."""
    root = Path(trajopt_torch.__file__).resolve().parent
    mods = sorted(
        "trajopt_torch." + ".".join(p.relative_to(root).with_suffix("").parts)
        for p in root.rglob("*.py") if p.name != "__init__.py"
    )
    code = (
        "import sys\n"
        "pre = set(sys.modules)\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['trajopt_tpu'] = None\n"
        "import importlib\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = [m for m, v in sys.modules.items() if v is not None and m not in pre and "
        "(m.split('.')[0] in ('jax', 'jaxlib', 'trajopt_tpu'))]\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=str(root.parent))
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    imports = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|trajopt_tpu)\b", re.M)
    for p in root.rglob("*.py"):
        assert not imports.search(p.read_text()), p


def test_precision_pin_is_set():
    """trajopt_torch/__init__.py pins full-f32 matmuls and turns TF32 off, the
    counterpart of the JAX package's matmul-precision invariant."""
    assert torch.get_float32_matmul_precision() == "highest"
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False


def test_wrappers_never_fall_back_and_count_only_launches():
    """A wrapper runs its plain version only for CPU tensors: any other device
    goes to the kernel path, which refuses a non-CUDA tensor instead of
    computing on it.  Plain runs never count as launches."""
    from trajopt_torch.core import cuda_fused, cuda_lqr, cuda_rollout

    env = trajopt_torch.make("Cartpole-TO-v0")
    T, Np = 3, 32
    z = lambda *s: torch.zeros(*s, device="meta")  # noqa: E731
    packed = dict(cxx=z(T, 16, Np), cx=z(T, 4, Np), cuu=z(T, 1, Np), cu=z(T, 1, Np),
                  cxu=z(T, 4, Np), A=z(T, 16, Np), B=z(T, 4, Np), vT=z(16, Np), vvT=z(4, Np))
    streams = (z(T, 4, Np), z(T, 1, Np), z(T, 4, Np), z(T, 1, Np))
    calls = [
        lambda: cuda_lqr.cuda_ilqr_backward_packed(packed, z(Np), 1),
        lambda: cuda_fused.cuda_ilqr_backward_fused(
            env, z(T, 4, Np), z(T, 1, Np), z(T, 1, Np), z(4, Np), z(T + 1), z(Np), 1),
        lambda: cuda_rollout.cuda_rollout_returns(env, *streams, z(T + 1), z(3)),
        lambda: cuda_rollout.cuda_rollout_selected(env, *streams, z(T + 1), z(Np)),
    ]
    for call in calls:
        with pytest.raises(ValueError, match="CUDA device"):
            call()
    for wrapper in (cuda_lqr.cuda_ilqr_backward_packed, cuda_fused.cuda_ilqr_backward_fused,
                    cuda_rollout.cuda_rollout_returns, cuda_rollout.cuda_rollout_selected):
        assert wrapper.launches == 0
