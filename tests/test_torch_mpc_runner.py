"""The port's MPC drivers against trajopt_tpu's, float64 on the CPU.

``make_mpc_runner`` and ``make_mpc_runner_batched`` on Pendulum-TO-v0
(dt=0.05, uw=1e-5; horizon 10, 6 steps, 3 iterations, 3 episodes) with JAX's
process noise handed in and the initial states given, both held to JAX's
``make_mpc_runner`` episode by episode; ``run_mpc_batch``'s two modes; the
mesh, not ported yet, raises.  The JAX reference is compiled once."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import trajopt_tpu
from trajopt_torch.parallel import mpc as port
from trajopt_torch.utils.convert import env_from_fields
from trajopt_tpu.parallel import mpc as jax_mpc

torch.set_num_threads(1)

HORIZON, STEPS, MPC_ITER, EPISODES = 10, 6, 3, 3
TOL = dict(rtol=1e-7, atol=1e-9)
F64 = dict(device="cpu", dtype=torch.float64)


def _compiled(f, *args):
    """``jax.jit(f)`` compiled for ``args`` without XLA's backend (LLVM)
    optimizations: a shorter compile, rounding that differs from the default
    compile's at the 1e-14 level."""
    return jax.jit(f).lower(*args).compile(
        {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True})


@pytest.fixture(scope="module")
def ref():
    jenv = trajopt_tpu.make("Pendulum-TO-v0", dt=0.05).replace(uw=(1e-5,))
    keys = jax.random.split(jax.random.PRNGKey(0), EPISODES)
    x0s = np.asarray(jenv.x0) + 0.1 * np.random.default_rng(0).standard_normal((EPISODES, 2))
    # the additive noise of JAX's env.step: multivariate_normal(k, 0, Σ) = chol(Σ) z
    noise = jax.jit(jax.vmap(lambda k: jax.vmap(
        lambda kk: jax.random.multivariate_normal(kk, jnp.zeros(2), jenv.sigma)
    )(jax.random.split(k, STEPS))))(keys)
    run = _compiled(jax_mpc.make_mpc_runner(jenv, HORIZON, STEPS, nb_iter=MPC_ITER), keys[0],
                    jnp.asarray(x0s[0]))
    episodes = [run(keys[i], jnp.asarray(x0s[i])) for i in range(EPISODES)]
    return dict(
        env=env_from_fields("Pendulum-TO-v0", dataclasses.asdict(jenv)), x0s=x0s,
        noise=np.array(noise),
        mpc=[np.stack([np.asarray(e[k]) for e in episodes]) for k in range(3)],
    )


def test_mpc_runner_matches_jax(ref):
    run = port.make_mpc_runner(ref["env"], HORIZON, STEPS, nb_iter=MPC_ITER, **F64)
    outs = [run(torch.as_tensor(ref["x0s"][i]), noise=torch.as_tensor(ref["noise"][i]))
            for i in range(EPISODES)]
    for i, (got, want) in enumerate(zip(zip(*outs), ref["mpc"])):
        np.testing.assert_allclose(torch.stack(got).numpy(), want, err_msg=str(i), **TOL)


def test_mpc_runner_batched_matches_jax(ref):
    """Against JAX's episodes one by one: JAX's own tests hold its batched
    runner to them (tests/test_mpc.py::test_batched_mpc_sharded_matches_vmapped)."""
    run = port.make_mpc_runner_batched(ref["env"], HORIZON, STEPS, nb_iter=MPC_ITER, **F64)
    got = run(torch.as_tensor(ref["x0s"]), noise=torch.as_tensor(ref["noise"]))
    for i, (a, want) in enumerate(zip(got, ref["mpc"])):
        np.testing.assert_allclose(a.numpy(), want, err_msg=str(i), **TOL)


def test_run_mpc_batch_modes_agree(ref):
    """Both modes draw the initial states and the noise up front from the
    generator, so they run the same episodes."""
    def run(batched):
        return port.run_mpc_batch(ref["env"], torch.Generator().manual_seed(3), 2, 5, 2,
                                  nb_iter=1, batched=batched, **F64)

    a, b = run(False), run(True)
    assert a["x"].shape == (2, 3, 2) and a["u"].shape == (2, 2, 1) and a["c"].shape == (2, 2)
    for k in ("x", "u", "c"):
        np.testing.assert_allclose(a[k].numpy(), b[k].numpy(), rtol=1e-12, atol=1e-14)


def test_mesh_is_not_ported(ref):
    with pytest.raises(NotImplementedError, match="row 17"):
        port.run_mpc_batch(ref["env"], None, 2, 5, 2, mesh=object(), **F64)
