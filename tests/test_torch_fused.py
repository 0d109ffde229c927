"""Parity of K1's plain version (trajopt_torch/core/cuda_fused.py) with the
interpret-mode ``pallas_ilqr_backward_fused`` of trajopt_tpu, float64 on the
CPU: Cartpole and Pendulum v0 on a trajectory with actions exactly at ±umax,
v1 (cos/sin features) with reg 2, and the slew-rate cost under a sigmoid
activation.

The interpret-mode kernel runs with ``time_chunk=1``: the interpreter compiles
the unrolled chunk body, so one step per grid trip keeps the call short.  The
JAX references and trajectories are frozen (``tests/make_torch_refs.py``)."""

import dataclasses
import hashlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import trajopt_tpu
from trajopt_torch.core.cuda_fused import cuda_ilqr_backward_fused
from trajopt_torch.core.cuda_lqr import from_soa, lane_pad, pad_lanes, to_soa
from trajopt_torch.solvers.common import make_weighting
from trajopt_torch.utils.convert import env_from_fields
from trajopt_tpu.core.pallas_fused import pallas_ilqr_backward_fused
from trajopt_tpu.core.pallas_lqr import _to_lanes, pack_scalar, unpack_lanes
from trajopt_tpu.solvers.common import make_weighting as jax_weighting

from make_torch_refs import frozen

torch.set_num_threads(1)

TOL = dict(rtol=1e-9, atol=1e-11)


def _compiled(f, *args):
    """``jax.jit(f)`` compiled for ``args`` without XLA's backend (LLVM)
    optimizations and its fusion pass: about half the compile time, rounding
    that differs from the default compile's at the 1e-14 level."""
    return jax.jit(f).lower(*args).compile(
        {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True,
         "xla_disable_hlo_passes": "fusion"})


def _trajectory(jenv, N, T, seed, saturate=False):
    """Reference trajectory rolled out with the JAX env; ``saturate`` puts
    actions exactly at ±umax on half the steps."""
    key = hashlib.sha256(repr((jenv, N, T, seed, saturate)).encode()).hexdigest()[:16]
    return frozen(__file__, f"trajectory-{key}",
                  lambda: _trajectory_live(jenv, N, T, seed, saturate))


def _trajectory_live(jenv, N, T, seed, saturate):
    rng = np.random.default_rng(seed)
    us = 0.3 * rng.standard_normal((N, T, jenv.dm_act))
    if saturate:
        umax = jenv.umax[0]
        us[:, ::2, 0] = np.where(rng.random((N, (T + 1) // 2)) < 0.5, umax, -umax)
    x = np.tile(np.asarray(jenv.x0), (N, 1)) + 0.3 * rng.standard_normal((N, jenv.dm_state))
    step = jax.jit(jax.vmap(jenv.dynamics))
    xs = [x]
    for t in range(T):
        x = np.asarray(step(jnp.asarray(x), jnp.asarray(us[:, t])))
        xs.append(x)
    return np.stack(xs, axis=1), us


@pytest.mark.parametrize(
    "name,kw,reg,lam,saturate,activation",
    [
        ("Cartpole-TO-v0", {}, 1, 0.1, True, None),
        ("Cartpole-TO-v1", {}, 2, 0.7, False, None),
        ("Cartpole-TO-v0", {"slew_rate": True}, 1, 0.2, False, {"mult": 0.5, "shift": 4.0}),
        ("Pendulum-TO-v0", {}, 1, 0.1, True, None),
        ("Pendulum-TO-v1", {}, 2, 0.7, False, None),
        ("Pendulum-TO-v0", {"slew_rate": True}, 1, 0.2, False, {"mult": 0.5, "shift": 4.0}),
    ],
)
def test_k1_plain_matches_pallas_fused_interpret(name, kw, reg, lam, saturate, activation):
    jenv = trajopt_tpu.make(name, **kw)
    tenv = env_from_fields(name, dataclasses.asdict(jenv))
    N, T = 4, 8
    xref, uref = _trajectory(jenv, N, T, seed=3, saturate=saturate)
    if saturate:
        assert np.any(np.abs(uref) == jenv.umax[0])
    lam_v = np.full(N, lam)
    ulast = np.concatenate([np.zeros_like(uref[:, :1]), uref[:, :-1]], axis=1)

    # called the way tests/test_pallas_fused.py calls the fused kernel, the
    # lane packing and the kernel compiled as one program
    n_pad_j = 128

    def reference(xref, uref, ulast, w_j, lam_v):
        Kl, kffl, dVl, badl = pallas_ilqr_backward_fused(
            jenv, _to_lanes(xref[:, :T], n_pad_j), _to_lanes(uref, n_pad_j),
            _to_lanes(ulast, n_pad_j), _to_lanes(xref[:, T][:, None], n_pad_j)[0],
            w_j, pack_scalar(lam_v, n_pad_j), reg, time_chunk=1, interpret=True,
        )
        return unpack_lanes(Kl, kffl, dVl, badl, N, T, jenv.dm_state, jenv.dm_act)

    args = (*(jnp.asarray(a) for a in (xref, uref, ulast)), jax_weighting(T, activation),
            jnp.asarray(lam_v))
    pol_j, dV_j, div_j = frozen(__file__, f"k1-{name}-{kw}-{reg}-{lam}-{saturate}-{activation}",
                                lambda: _compiled(reference, *args)(*args))

    n_pad = lane_pad(N)
    w_t = make_weighting(T, activation, device="cpu", dtype=torch.float64)
    K_l, kff_l, dV_l, bad_l = cuda_ilqr_backward_fused(
        tenv, to_soa(torch.as_tensor(xref[:, :T]), n_pad), to_soa(torch.as_tensor(uref), n_pad),
        to_soa(torch.as_tensor(ulast), n_pad), to_soa(torch.as_tensor(xref[:, T:]), n_pad)[0],
        w_t, pad_lanes(torch.as_tensor(lam_v), n_pad), reg,
    )
    dx, du = jenv.dm_state, jenv.dm_act
    np.testing.assert_array_equal(bad_l[:N].numpy(), np.asarray(div_j))
    np.testing.assert_allclose(from_soa(K_l, N, (du, dx)).numpy(), np.asarray(pol_j.K), **TOL)
    np.testing.assert_allclose(from_soa(kff_l, N, (du,)).numpy(), np.asarray(pol_j.kff), **TOL)
    np.testing.assert_allclose(dV_l[:, :N].T.numpy(), np.asarray(dV_j), **TOL)


def test_fused_wrapper_rejects_bad_input():
    tenv = env_from_fields("Cartpole-TO-v0", {})
    x = torch.zeros(8, 4, 32, dtype=torch.float64)
    u = torch.zeros(8, 1, 32, dtype=torch.float64)
    w = torch.ones(9, dtype=torch.float64)
    lam = torch.ones(32, dtype=torch.float64)
    with pytest.raises(ValueError, match="reg"):
        cuda_ilqr_backward_fused(tenv, x, u, u, x[0], w, lam, reg=3)


@pytest.mark.parametrize("Np,refusal", [(16, "multiple of 32"), (48, "multiple of 32"),
                                        (1000, "multiple of 32"), (64, "CUDA device")])
def test_fused_wrapper_takes_whole_lane_groups(Np, refusal):
    """As K4's wrapper: a device batch whose lane count is not a multiple of 32
    is refused before any launch; a padded one reaches the device checks."""
    tenv = env_from_fields("Cartpole-TO-v0", {})
    T = 3
    z = lambda *s: torch.zeros(*s, device="meta")  # noqa: E731
    launches = cuda_ilqr_backward_fused.launches
    with pytest.raises(ValueError, match=refusal):
        cuda_ilqr_backward_fused(tenv, z(T, 4, Np), z(T, 1, Np), z(T, 1, Np), z(4, Np),
                                 z(T + 1), z(Np), 1)
    assert cuda_ilqr_backward_fused.launches == launches
