"""Parity of the port's backward passes with trajopt_tpu's, float64 on the CPU:
the scan ``ilqr_backward`` against JAX's, and K4's plain version against the
interpret-mode ``pallas_ilqr_backward`` (K1's is in test_torch_fused.py).  The
JAX references are frozen (``tests/make_torch_refs.py``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trajopt_torch.core.cuda_lqr import (
    cuda_ilqr_backward_packed,
    from_soa,
    lane_pad,
    pack_lanes,
    pad_lanes,
)
from trajopt_torch.core.scan_lqr import ilqr_backward
from trajopt_torch.core.types import QuadraticCost
from trajopt_tpu.core import scan_lqr as jax_scan
from trajopt_tpu.core import types as jax_types
from trajopt_tpu.core.pallas_lqr import pallas_ilqr_backward

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


def _random_lqr(rng, N, T, dx, du, non_pd=False):
    """Random delta-convention problem ``(N, T+1, …)``; ``non_pd`` makes Cuu
    negative at one step of instance 0 so that reg=1 with small λ fails."""
    def spd(*shape, d, s):
        M = rng.standard_normal(shape + (d, d))
        return s * np.einsum("...ij,...kj->...ik", M, M) + 0.5 * np.eye(d)

    cost = dict(
        Cxx=spd(N, T + 1, d=dx, s=0.3), cx=rng.standard_normal((N, T + 1, dx)),
        Cuu=spd(N, T + 1, d=du, s=0.2), cu=rng.standard_normal((N, T + 1, du)),
        Cxu=0.05 * rng.standard_normal((N, T + 1, dx, du)), c0=np.zeros((N, T + 1)),
    )
    if non_pd:
        cost["Cuu"][0, T // 2] = -50.0 * np.eye(du)
    A = np.eye(dx) + 0.1 * rng.standard_normal((N, T, dx, dx))
    B = 0.3 * rng.standard_normal((N, T, dx, du))
    return cost, A, B


def _jax_scan(cost, A, B, lam, reg):
    jc = jax_types.QuadraticCost(**{k: jnp.asarray(v) for k, v in cost.items()})

    def one(c, a, b, l):
        pol, value, _, dV, div = jax_scan.ilqr_backward(c, a, b, l, reg)
        return pol.K, pol.kff, value.V, dV, div

    return [np.asarray(o) for o in jax.jit(jax.vmap(one))(jc, jnp.asarray(A), jnp.asarray(B),
                                                           jnp.asarray(lam))]


def _torch_cost(cost):
    return QuadraticCost(**{k: torch.as_tensor(v) for k, v in cost.items()})


@pytest.mark.parametrize(
    "reg,lam,dims,non_pd",
    [(1, 0.3, (4, 1), False), (2, 0.7, (3, 2), False), (1, 0.0, (3, 2), True),
     (1, 0.0, (4, 1), True)],
)
def test_scan_ilqr_backward_matches_jax(reg, lam, dims, non_pd):
    dx, du = dims
    N, T = 3, 10
    cost, A, B = _random_lqr(np.random.default_rng(reg + 10 * du), N, T, dx, du, non_pd)
    lam_v = np.full(N, lam)
    K_j, kff_j, V_j, dV_j, div_j = frozen(__file__, f"scan-{reg}-{lam}-{dims}-{non_pd}",
                                          lambda: _jax_scan(cost, A, B, lam_v, reg))
    pol, value, _, dV_t, div_t = ilqr_backward(
        _torch_cost(cost), torch.as_tensor(A), torch.as_tensor(B), torch.as_tensor(lam_v), reg
    )
    np.testing.assert_array_equal(div_t.numpy(), div_j)
    assert div_j[0] == non_pd
    np.testing.assert_allclose(pol.K.numpy(), K_j, **TOL)
    np.testing.assert_allclose(pol.kff.numpy(), kff_j, **TOL)
    np.testing.assert_allclose(value.V.numpy(), V_j, **TOL)
    np.testing.assert_allclose(dV_t.numpy(), dV_j, **TOL)


@pytest.mark.parametrize("reg,lam,dims,non_pd", [(1, 0.4, (4, 1), False),
                                                 (2, 0.9, (3, 2), False),
                                                 (1, 0.0, (3, 2), True)])
def test_k4_plain_matches_pallas_interpret(reg, lam, dims, non_pd):
    dx, du = dims
    N, T = 4, 8
    cost, A, B = _random_lqr(np.random.default_rng(7 + du), N, T, dx, du, non_pd)
    lam_v = np.full(N, lam)
    jc = jax_types.QuadraticCost(**{k: jnp.asarray(v) for k, v in cost.items()})
    # compiled with the lane packing: run eagerly, each packing operation
    # would compile on its own
    args = (jc, jnp.asarray(A), jnp.asarray(B), jnp.asarray(lam_v))
    pol_j, dV_j, div_j = frozen(__file__, f"k4-{reg}-{lam}-{dims}-{non_pd}", lambda: _compiled(
        lambda c, A, B, lam: pallas_ilqr_backward(c, A, B, lam, reg, time_chunk=1,
                                                  interpret=True), *args)(*args))
    n_pad = lane_pad(N)
    packed = pack_lanes(_torch_cost(cost), torch.as_tensor(A), torch.as_tensor(B), n_pad)
    K_l, kff_l, dV_l, bad_l = cuda_ilqr_backward_packed(
        packed, pad_lanes(torch.as_tensor(lam_v), n_pad), reg
    )
    np.testing.assert_array_equal(bad_l[:N].numpy(), np.asarray(div_j))
    np.testing.assert_allclose(from_soa(K_l, N, (du, dx)).numpy(), np.asarray(pol_j.K), **TOL)
    np.testing.assert_allclose(from_soa(kff_l, N, (du,)).numpy(), np.asarray(pol_j.kff), **TOL)
    np.testing.assert_allclose(dV_l[:, :N].T.numpy(), np.asarray(dV_j), **TOL)


def test_k4_wrapper_rejects_bad_reg():
    cost, A, B = _random_lqr(np.random.default_rng(0), 2, 3, 4, 1)
    packed = pack_lanes(_torch_cost(cost), torch.as_tensor(A), torch.as_tensor(B), 32)
    with pytest.raises(ValueError, match="reg"):
        cuda_ilqr_backward_packed(packed, torch.ones(32, dtype=torch.float64), reg=3)


@pytest.mark.parametrize("Np,refusal", [(16, "multiple of 32"), (48, "multiple of 32"),
                                        (1000, "multiple of 32"), (64, "CUDA device")])
def test_k4_wrapper_takes_whole_lane_groups(Np, refusal):
    """The staged kernel takes whole groups of instances: a device batch whose
    lane count is not lane_pad's multiple of 32 is refused before any launch;
    a padded one passes on to the device checks (here: meta tensors)."""
    T = 3
    z = lambda *s: torch.zeros(*s, device="meta")  # noqa: E731
    packed = dict(cxx=z(T, 16, Np), cx=z(T, 4, Np), cuu=z(T, 1, Np), cu=z(T, 1, Np),
                  cxu=z(T, 4, Np), A=z(T, 16, Np), B=z(T, 4, Np), vT=z(16, Np), vvT=z(4, Np))
    launches = cuda_ilqr_backward_packed.launches
    with pytest.raises(ValueError, match=refusal):
        cuda_ilqr_backward_packed(packed, z(Np), 1)
    assert cuda_ilqr_backward_packed.launches == launches
