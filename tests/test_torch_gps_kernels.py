"""The port's GPS dual chain against trajopt_tpu's, float64 on the CPU.

The scan kernels of ``core/scan_lqr`` (``augment_cost_kl``, ``gps_backward``,
``gaussian_forward``, ``policy_kl``, ``quad_expectation``) against JAX's at
rtol 1e-10, and the plain versions of K6 and K7 (``core/cuda_gps``, which run
for CPU tensors) against ``pallas_gps_backward`` / ``pallas_gps_forward_kl``
in interpret mode (``time_chunk=1``) at rtol 1e-9 with equal flags, at
(N, T) = (4, 9) for (dx, du) = (2, 1) and (4, 2).  In the (2, 1) problem,
instance 2 has a non-PD −Quu at t = 1: the kernels keep it finite and flag
it, the scan chain flags it with NaN, each as its JAX engine does.  Instance
3 has it at t = T/2 with α = 1e-16, where the guarded value recursion of
both the TPU kernel and K6 runs to ±inf by t = 0: flags and the places of
the non-finite entries agree too.  Each JAX reference runs once per module."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trajopt_torch.core import cuda_gps
from trajopt_torch.core import scan_lqr as port
from trajopt_torch.core import types as tt
from trajopt_tpu.core import pallas_gps as jax_pallas
from trajopt_tpu.core import scan_lqr as jax_scan
from trajopt_tpu.core import types as jt

torch.set_num_threads(1)

N, T = 4, 9
DIMS = [(2, 1), (4, 2)]
TOL = dict(rtol=1e-10, atol=1e-12)
TOL_KERNEL = dict(rtol=1e-9, atol=1e-11)
PARTS = {"cost": ("QuadraticCost", ("Cxx", "cx", "Cuu", "cu", "Cxu", "c0")),
         "dyn": ("LinearGaussianDynamics", ("A", "B", "c", "sigma")),
         "old": ("LinearGaussianPolicy", ("K", "kff", "sigma"))}


def _compiled(f, *args):
    """``jax.jit(f)`` compiled for ``args`` without XLA's backend (LLVM)
    optimizations: a shorter compile, rounding that differs from the default
    compile's at the 1e-14 level."""
    return jax.jit(f).lower(*args).compile(
        {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True})


@functools.lru_cache(maxsize=None)
def _problem(dx, du):
    """Batch-leading numpy operands; for du = 1, instance 2's action cost at
    t = 1 and instance 3's at t = T/2 (with α = 1e-16) make −Quu indefinite."""
    rng = np.random.default_rng(10 * dx + du)

    def spd(d, n, s=1.0):
        M = rng.standard_normal((N, n, d, d))
        return s * (np.einsum("bnij,bnkj->bnik", M, M) + d * np.eye(d))

    Cuu = spd(du, T + 1)
    alpha = np.exp(rng.standard_normal((N, T)))
    if du == 1:
        Cuu[2, 1] = Cuu[3, T // 2] = -50.0
        alpha[3] = 1e-16
    return dict(
        cost=dict(Cxx=spd(dx, T + 1), cx=rng.standard_normal((N, T + 1, dx)), Cuu=Cuu,
                  cu=rng.standard_normal((N, T + 1, du)),
                  Cxu=0.1 * rng.standard_normal((N, T + 1, dx, du)),
                  c0=0.1 * rng.standard_normal((N, T + 1))),
        dyn=dict(A=0.9 * (np.eye(dx) + 0.1 * rng.standard_normal((N, T, dx, dx))),
                 B=0.5 * rng.standard_normal((N, T, dx, du)),
                 c=0.1 * rng.standard_normal((N, T, dx)), sigma=spd(dx, T, 0.01)),
        old=dict(K=0.1 * rng.standard_normal((N, T, du, dx)),
                 kff=0.1 * rng.standard_normal((N, T, du)), sigma=spd(du, T, 0.5)),
        alpha=alpha,
        mu0=rng.standard_normal((N, dx)), sigma0=spd(dx, 1, 0.1)[:, 0],
    )


def _containers(p, types, conv):
    out = {k: getattr(types, name)(*(conv(p[k][f]) for f in fields))
           for k, (name, fields) in PARTS.items()}
    return out["cost"], out["dyn"], out["old"], conv(p["alpha"]), conv(p["mu0"]), conv(p["sigma0"])


@jax.jit
def _jax_chain(cost, dyn, old, alpha, mu0, sigma0):
    def one(c, d, o, a, m, s):
        ag = jax_scan.augment_cost_kl(c, o, a)
        lgc, value, qvalue, div = jax_scan.gps_backward(ag, d, a)
        xdist, udist, xudist = jax_scan.gaussian_forward(d, lgc, m, s)
        kl = jax_scan.policy_kl(lgc, o, xdist)
        qe = jax_scan.quad_expectation(m, s, value.V[0], value.v[0], value.v0[0])
        return ag, lgc, value, qvalue, div, xdist, udist, xudist, kl, qe

    return jax.vmap(one)(cost, dyn, old, alpha, mu0, sigma0)


@functools.lru_cache(maxsize=None)
def _scan(dims):
    """(JAX's, the port's) scan chain outputs on the problem of ``dims``."""
    p = _problem(*dims)
    ref = jax.tree.map(np.asarray, _jax_chain(*_containers(p, jt, jnp.asarray)))
    cost, dyn, old, alpha, mu0, sigma0 = _containers(p, tt, torch.as_tensor)
    ag = port.augment_cost_kl(cost, old, alpha)
    lgc, value, qvalue, div = port.gps_backward(ag, dyn, alpha)
    xdist, udist, xudist = port.gaussian_forward(dyn, lgc, mu0, sigma0)
    kl = port.policy_kl(lgc, old, xdist)
    qe = port.quad_expectation(mu0, sigma0, value.V[:, 0], value.v[:, 0], value.v0[:, 0])
    return ref, (ag, lgc, value, qvalue, div, xdist, udist, xudist, kl, qe)


@functools.lru_cache(maxsize=None)
def _pallas(dims):
    """The interpret-mode Pallas kernels on the problem of ``dims``: K6's
    outputs, then K7's on K6's policy, compiled as one program."""
    def kernels(cost, dyn, old, alpha, mu0, sigma0):
        bwd = jax_pallas.pallas_gps_backward(cost, dyn, old, alpha, time_chunk=1, interpret=True)
        fwd = jax_pallas.pallas_gps_forward_kl(dyn, bwd[0], old, mu0, sigma0, time_chunk=1,
                                               interpret=True)
        return bwd, fwd

    args = _containers(_problem(*dims), jt, jnp.asarray)
    return jax.tree.map(np.asarray, _compiled(kernels, *args)(*args))


def _close(got, want, tol=TOL):
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w, **tol)


@pytest.mark.parametrize("dims", DIMS)
def test_augment_cost_kl_matches_jax(dims):
    ref, out = _scan(dims)
    _close(out[0], ref[0])


@pytest.mark.parametrize("dims", DIMS)
def test_gps_backward_matches_jax(dims):
    ref, out = _scan(dims)
    for i in (1, 2, 3):                           # policy, value, qvalue
        _close(out[i], ref[i])
    np.testing.assert_array_equal(out[4].numpy(), ref[4])


@pytest.mark.parametrize("dims", DIMS)
def test_gaussian_forward_matches_jax(dims):
    ref, out = _scan(dims)
    for i in (5, 6, 7):                           # xdist, udist, xudist
        _close(out[i], ref[i])


@pytest.mark.parametrize("dims", DIMS)
def test_policy_kl_and_quad_expectation_match_jax(dims):
    ref, out = _scan(dims)
    _close(out[8:], ref[8:])


@pytest.mark.parametrize("dims", DIMS)
def test_k6_plain_matches_pallas_interpret(dims):
    (pol_r, V0_r, v0_r, c0_r, div_r), _ = _pallas(dims)
    cost, dyn, old, alpha, _, _ = _containers(_problem(*dims), tt, torch.as_tensor)
    pol, V0, v0, c0, div = cuda_gps.cuda_gps_backward(cost, dyn, old, alpha)
    _close(pol, pol_r, TOL_KERNEL)
    _close((V0, v0, c0), (V0_r, v0_r, c0_r), TOL_KERNEL)
    np.testing.assert_array_equal(div.numpy(), div_r)
    # CPU tensors ran the plain version: no launch counted
    assert cuda_gps.cuda_gps_backward_packed.launches == 0


@pytest.mark.parametrize("dims", DIMS)
def test_k7_plain_matches_pallas_interpret(dims):
    (pol_r, *_), fwd_r = _pallas(dims)
    _, dyn, old, _, mu0, sigma0 = _containers(_problem(*dims), tt, torch.as_tensor)
    new = tt.LinearGaussianPolicy(*(torch.as_tensor(x) for x in pol_r))
    _close(cuda_gps.cuda_gps_forward_kl(dyn, new, old, mu0, sigma0), fwd_r, TOL_KERNEL)
    assert cuda_gps.cuda_gps_forward_kl_packed.launches == 0


def test_non_pd_step_keeps_each_engines_divergence_semantics():
    """Instances 2 and 3 of the (2, 1) problem: the scan chain
    (``jnp.linalg.cholesky``'s NaN contract) flags both and their v0 goes NaN.
    K6 (the TPU kernel's guard: a bad pivot becomes 1) flags both; instance
    2, indefinite at t = 1, keeps every output finite, and instance 3,
    indefinite at t = T/2 with α = 1e-16, reaches t = 0 with an infinite
    value, as the interpret-mode TPU kernel does (K6 and K7 are held to it
    entry by entry, non-finite places included, by the tests above)."""
    flagged = np.array([False, False, True, True])
    _, (_, _, value, _, div, *_) = _scan((2, 1))
    np.testing.assert_array_equal(div.numpy(), flagged)
    assert torch.isnan(value.v0[2:]).any(-1).all() and torch.isfinite(value.v0[:2]).all()
    cost, dyn, old, alpha, mu0, sigma0 = _containers(_problem(2, 1), tt, torch.as_tensor)
    pol, V0, v0, c0, div_k = cuda_gps.cuda_gps_backward(cost, dyn, old, alpha)
    np.testing.assert_array_equal(div_k.numpy(), flagged)
    (pol_r, V0_r, *_), _ = _pallas((2, 1))
    np.testing.assert_array_equal(_pallas((2, 1))[0][4], flagged)
    assert all(bool(torch.isfinite(x[:3]).all()) for x in (*pol, V0, v0, c0))
    assert torch.isinf(V0[3]).all() and np.isinf(V0_r[3]).all()
    kl, muT, sigT = cuda_gps.cuda_gps_forward_kl(dyn, pol, old, mu0, sigma0)
    assert not torch.isfinite(kl[3]) and torch.isfinite(kl[:3]).all()


def test_packed_chain_matches_scan_chain():
    """One dual evaluation as the solver runs it (pack once, α plane, K6's
    streams straight into K7) against the port's scan chain, with the
    initial-state quadratic expectation on K6's value outputs."""
    _, (_, lgc, _, _, _, xdist, _, _, kl, qe) = _scan((4, 2))
    cost, dyn, old, alpha, mu0, sigma0 = _containers(_problem(4, 2), tt, torch.as_tensor)
    packed = cuda_gps.pack_gps(cost, dyn, old, mu0, sigma0)
    K_l, kff_l, sigc_l, V0_l, vv0_l, c0_l, bad = cuda_gps.cuda_gps_backward_packed(
        packed, cuda_gps.pack_gps_alpha(alpha))
    kl_l, muT_l, sigT_l = cuda_gps.cuda_gps_forward_kl_packed(packed, K_l, kff_l, sigc_l)
    _close(cuda_gps.unpack_gps_policy(K_l, kff_l, sigc_l, 4, 2), lgc)
    np.testing.assert_allclose(kl_l[0].numpy(), kl.sum(-1).numpy(), **TOL)
    np.testing.assert_allclose(muT_l.T.numpy(), xdist.mu[:, -1].numpy(), **TOL)
    np.testing.assert_allclose(sigT_l.T.reshape(N, 4, 4).numpy(), xdist.sigma[:, -1].numpy(),
                               **TOL)
    qe_l = cuda_gps.quad_expectation_lanes(V0_l, vv0_l, c0_l, packed["mu0"], packed["sig0"])
    np.testing.assert_allclose(qe_l.numpy(), qe.numpy(), **TOL)
    assert not bad.any()
