"""The port's GPS-MPC runners against trajopt_tpu's, float64 on the CPU.

``make_gps_mpc_runner`` and ``make_gps_mpc_runner_batched`` (engines
``scan`` and ``cuda``, the latter K6/K7's plain versions on CPU tensors) on
Pendulum-TO-v0 (dt=0.05; horizon 6, 2 steps, 2 iterations, kl_bound=2.0,
action_penalty=1e-5, 12 bisection steps; 2 episodes), with JAX's draws (each
solve's initial kff and each step's process noise) handed in and the initial
states given, held to JAX's ``make_gps_mpc_runner`` episode by episode;
``run_gps_mpc_batch``'s two modes on the draws of ``gps_mpc_draws``; the
mesh, not ported yet, raises.  The JAX reference is compiled once."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import trajopt_tpu
from trajopt_torch.parallel import gps as port
from trajopt_torch.utils.convert import env_from_fields
from trajopt_tpu.parallel import gps as jax_gps

torch.set_num_threads(1)

HORIZON, STEPS, EPISODES = 6, 2, 2
GPS_KW = dict(nb_iter=2, kl_bound=2.0, action_penalty=1e-5, bisect_iters=12)
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
    jenv = trajopt_tpu.make("Pendulum-TO-v0", dt=0.05)
    keys = jax.random.split(jax.random.PRNGKey(0), EPISODES)
    x0s = np.asarray(jenv.x0) + 0.1 * np.random.default_rng(0).standard_normal((EPISODES, 2))

    def draws(key):
        """JAX's runner draws, step by step: split(key, steps), then each
        step's key into (solve, step); the solve draws kff = 1e-4·N(0, 1) and
        env.step adds multivariate_normal(k, 0, Σ) = chol(Σ) z."""
        def one(k):
            k_solve, k_step = jax.random.split(k)
            return (1e-4 * jax.random.normal(k_solve, (HORIZON, 1), jnp.float64),
                    jax.random.multivariate_normal(k_step, jnp.zeros(2), jenv.sigma))

        return jax.vmap(one)(jax.random.split(key, STEPS))

    kff, noise = jax.jit(jax.vmap(draws))(keys)
    run = _compiled(jax_gps.make_gps_mpc_runner(jenv, HORIZON, STEPS, **GPS_KW), keys[0],
                    jnp.asarray(x0s[0]))
    episodes = [run(keys[i], jnp.asarray(x0s[i])) for i in range(EPISODES)]
    return dict(
        env=env_from_fields("Pendulum-TO-v0", dataclasses.asdict(jenv)), x0s=x0s,
        kff=np.array(kff), noise=np.array(noise),
        mpc=[np.stack([np.asarray(e[k]) for e in episodes]) for k in range(3)],
    )


def test_gps_mpc_runner_matches_jax(ref):
    run = port.make_gps_mpc_runner(ref["env"], HORIZON, STEPS, **GPS_KW, **F64)
    outs = [run(torch.as_tensor(ref["x0s"][i]), kff_init=torch.as_tensor(ref["kff"][i]),
                noise=torch.as_tensor(ref["noise"][i])) for i in range(EPISODES)]
    for i, (got, want) in enumerate(zip(zip(*outs), ref["mpc"])):
        np.testing.assert_allclose(torch.stack(got).numpy(), want, err_msg=str(i), **TOL)


@pytest.mark.parametrize("engine", ["scan", "cuda"])
def test_gps_mpc_runner_batched_matches_jax(ref, engine):
    """Against JAX's episodes one by one: JAX's batched runner follows the key
    streams of vmapping its single runner."""
    run = port.make_gps_mpc_runner_batched(ref["env"], HORIZON, STEPS, engine=engine, **GPS_KW,
                                           **F64)
    got = run(torch.as_tensor(ref["x0s"]), kff_init=torch.as_tensor(ref["kff"]),
              noise=torch.as_tensor(ref["noise"]))
    for i, (a, want) in enumerate(zip(got, ref["mpc"])):
        np.testing.assert_allclose(a.numpy(), want, err_msg=str(i), **TOL)


def test_run_gps_mpc_batch_modes_agree(ref):
    """Both modes draw the initial states, the solves' kff and the noise up
    front with ``gps_mpc_draws``, so they run the same episodes: those of the
    batched runner on the draws it makes from the same seed."""
    def run(batched):
        return port.run_gps_mpc_batch(ref["env"], torch.Generator().manual_seed(3), 2, 4, 2,
                                      nb_iter=1, bisect_iters=6, batched=batched, **F64)

    a, b = run(False), run(True)
    assert a["x"].shape == (2, 3, 2) and a["u"].shape == (2, 2, 1) and a["c"].shape == (2, 2)
    x0s, kff, noise = port.gps_mpc_draws(ref["env"], torch.Generator().manual_seed(3), 2, 4, 2,
                                         **F64)
    c = port.make_gps_mpc_runner_batched(ref["env"], 4, 2, nb_iter=1, bisect_iters=6, **F64)(
        x0s, kff_init=kff, noise=noise)
    for k, want in zip(("x", "u", "c"), c):
        np.testing.assert_allclose(a[k].numpy(), b[k].numpy(), rtol=1e-12, atol=1e-14)
        np.testing.assert_array_equal(b[k].numpy(), want.numpy())


def test_mesh_is_not_ported(ref):
    with pytest.raises(NotImplementedError, match="row 17"):
        port.run_gps_mpc_batch(ref["env"], None, 2, 4, 2, mesh=object(), **F64)
