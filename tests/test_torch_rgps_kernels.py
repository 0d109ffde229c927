"""The port's robust-GPS kernels against trajopt_tpu's, float64 on the CPU.

``core/types`` (the column-major θ layout), the Gaussian KL and the KL/W2
geodesics of ``core/scan_lqr``, and ``core/cubature`` (cubature forward,
policy backward, parameter augmentation, parameter backward) against JAX at
rtol 1e-10 on seeded numpy problems (dims 2/1 and 3/2); the same functions
against the frozen fixtures of ``tests/goldens/rgps_pins.npz`` at
``TestRgpsPins``'s tolerances (tests/test_goldens.py:134-200); the non-PD
contract (a shrunk KL anchor): the flag, and NaN and sanitized entries in
the same places as JAX's scan path.  K15's and K16's plain versions
(``core/cuda_rgps``, which run for CPU tensors) against the interpret-mode
Pallas kernels (``time_chunk=1``, dims 2/1, p = 8) at the tolerances of
tests/test_pallas_rgps.py:109-110 and :177-179, with the non-PD flag case
(:116); K15's plain version against ``parameter_backward_pass`` at p = 28;
``cuda_rgps_fixed_point``'s freeze semantics against the ``vmap``ped JAX
``while_loop`` (:224, staggered convergence, rtol 1e-7); Robot-TO-v0
against JAX, and the iLQR/eLQR kernel engines refusing it; every kernel
source listed in the build.  Every JAX reference is frozen
(``tests/make_torch_refs.py``)."""

import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import trajopt_torch
import trajopt_tpu
from trajopt_torch.core import cubature as tc
from trajopt_torch.core import cuda_rgps as cr
from trajopt_torch.core import scan_lqr as ts
from trajopt_torch.core import types as tt
from trajopt_torch.kernels import _build
from trajopt_tpu.core import cubature as jc
from trajopt_tpu.core import scan_lqr as js
from trajopt_tpu.core import types as jt

from make_torch_refs import reference

torch.set_num_threads(1)

TOL = dict(rtol=1e-10, atol=1e-12)
GOLDENS = "tests/goldens/rgps_pins.npz"


def _t(a):
    return torch.as_tensor(np.array(a))


def _problem(N, T, dx, du, seed, anchor=1.0):
    """tests/test_pallas_rgps.py's problem, drawn with numpy: SPD cost
    blocks, a nominal near 0.9·I with Σθ = 1e-4·I, β = 200, the KL anchor
    scaled by ``anchor`` (1e-12 makes W indefinite)."""
    rng = np.random.default_rng(seed)
    p = dx * (dx + du + 1)

    def spd(d, n, s=1.0):
        M = rng.standard_normal((N, n, d, d))
        return s * (np.einsum("bnij,bnkj->bnik", M, M) + d * np.eye(d))

    A = 0.9 * (np.eye(dx) + 0.1 * rng.standard_normal((N, T, dx, dx)))
    B = 0.5 * rng.standard_normal((N, T, dx, du))
    c = 0.1 * rng.standard_normal((N, T, dx))
    return dict(
        cost=dict(Cxx=spd(dx, T + 1), cx=rng.standard_normal((N, T + 1, dx)),
                  Cuu=spd(du, T + 1), cu=rng.standard_normal((N, T + 1, du)),
                  Cxu=0.1 * rng.standard_normal((N, T + 1, dx, du)),
                  c0=0.1 * rng.standard_normal((N, T + 1))),
        theta=np.concatenate([A, B, c[..., None]], -1).swapaxes(-1, -2).reshape(N, T, p),
        nom_sigma=np.broadcast_to(1e-4 * np.eye(p), (N, T, p, p)).copy(),
        ctl=dict(K=0.1 * rng.standard_normal((N, T, du, dx)),
                 kff=0.1 * rng.standard_normal((N, T, du)),
                 sigma=np.broadcast_to(np.eye(du), (N, T, du, du)).copy()),
        noise=np.broadcast_to(1e-4 * np.eye(dx), (N, T, dx, dx)).copy(),
        mu0=0.3 * rng.standard_normal((N, dx)),
        sigma0=np.broadcast_to(0.01 * np.eye(dx), (N, dx, dx)).copy(),
        beta=np.full(N, 200.0), anchor=anchor,
    )


def _containers(pr, types, conv):
    return (types.QuadraticCost(**{k: conv(v) for k, v in pr["cost"].items()}),
            types.LinearGaussianPolicy(**{k: conv(v) for k, v in pr["ctl"].items()}),
            types.MatrixNormalParams(mu=conv(pr["theta"]), sigma=conv(pr["nom_sigma"])),
            conv(pr["noise"]), conv(pr["mu0"]), conv(pr["sigma0"]), conv(pr["beta"]))


CASES = {"2x1": (3, 5, 2, 1, 0), "3x2": (2, 4, 3, 2, 1)}


@reference(__file__)
def _jax_scan(case, anchor):
    """JAX's scan kernels on ``_problem``: cubature forward under the
    nominal, the augmentation, the parameter backward on that marginal, the
    policy backward at α = 10 and the cubature forward under its policy."""
    N, T, dx, du, seed = CASES[case]
    cost, ctl, nom, noise, mu0, sigma0, beta = _containers(
        _problem(N, T, dx, du, seed, anchor), jt, jnp.asarray)

    def one(cost, ctl, nom, noise, mu0, sigma0, beta):
        xdist, udist, xudist = jc.cubature_forward_pass(mu0, sigma0, nom, noise, ctl)
        agCpp, agcp, agc0 = jc.parameter_augment_cost(nom, beta)
        agCpp, agcp = anchor * agCpp, anchor * agcp
        param, value, div = jc.parameter_backward_pass(xdist, ctl, noise, cost, agCpp, agcp, beta)
        pol, pvalue, _, pdiv = jc.policy_backward_pass(cost, nom, noise, jnp.full(T, 10.0))
        return (xdist, udist, xudist, (agCpp, agcp, agc0), (param, value, div),
                (pol, pvalue, pdiv))

    return jax.jit(jax.vmap(one))(cost, ctl, nom, noise, mu0, sigma0, beta)


def _port_scan(case, anchor):
    N, T, dx, du, seed = CASES[case]
    cost, ctl, nom, noise, mu0, sigma0, beta = _containers(
        _problem(N, T, dx, du, seed, anchor), tt, _t)
    xdist, udist, xudist = tc.cubature_forward_pass(mu0, sigma0, nom, noise, ctl)
    agCpp, agcp, agc0 = tc.parameter_augment_cost(nom, beta)
    agCpp, agcp = anchor * agCpp, anchor * agcp
    param, value, div = tc.parameter_backward_pass(xdist, ctl, noise, cost, agCpp, agcp, beta)
    pol, pvalue, pdiv = tc.policy_backward_pass(cost, nom, noise,
                                                torch.full((N, T), 10.0, dtype=torch.float64))
    return (xdist, udist, xudist, (agCpp, agcp, agc0), (param, value, div), (pol, pvalue, pdiv))


def _close(got, want, tol=TOL, name=""):
    if isinstance(want, tuple):
        for i, (g, w) in enumerate(zip(got, want)):
            _close(g, w, tol, f"{name}.{i}")
        return
    g = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(g, want, err_msg=name, equal_nan=True, **tol)


def test_theta_layout_matches_jax():
    rng = np.random.default_rng(0)
    th = rng.standard_normal((2, 3, 18))
    A, B, c = tt.matrices_from_vec(_t(th), 3, 2)
    want = _theta_ref()
    for g, w in zip((A, B, c), want):
        np.testing.assert_array_equal(g.numpy(), w)
    np.testing.assert_array_equal(tt.vec_from_matrices(A, B, c).numpy(), th)


@reference(__file__)
def _theta_ref():
    th = np.random.default_rng(0).standard_normal((2, 3, 18))
    return jax.vmap(jax.vmap(lambda x: jt.matrices_from_vec(x, 3, 2)))(jnp.asarray(th))


@reference(__file__)
def _gaussian_ref():
    p, q = _gaussians()
    P, Q = (jt.GaussianSequence(jnp.asarray(m), jnp.asarray(s)) for m, s in (p, q))
    return js.gaussian_kl(P, Q), js.gaussian_interp_kl(Q, P, 0.1), js.gaussian_interp_w2(Q, P, 0.1)


def _gaussians():
    rng = np.random.default_rng(1)

    def spd(n, d):
        M = rng.standard_normal((n, d, d))
        return np.einsum("nij,nkj->nik", M, M) + d * np.eye(d)

    return ((rng.standard_normal((6, 3)), spd(6, 3)), (rng.standard_normal((6, 3)), spd(6, 3)))


def test_gaussian_kl_and_geodesics_match_jax():
    p, q = _gaussians()
    P, Q = (tt.GaussianSequence(_t(m), _t(s)) for m, s in (p, q))
    kl, ikl, iw2 = _gaussian_ref()
    _close(ts.gaussian_kl(P, Q), kl)
    _close(tuple(ts.gaussian_interp_kl(Q, P, 0.1)), tuple(ikl))
    _close(tuple(ts.gaussian_interp_w2(Q, P, 0.1)), tuple(iw2), dict(rtol=1e-9, atol=1e-12))


@pytest.mark.parametrize("case", list(CASES))
def test_cubature_functions_match_jax(case):
    want = _jax_scan(case, 1.0)
    got = _port_scan(case, 1.0)
    for name, g, w in zip(("xdist", "udist", "xudist", "augment", "adversary", "policy"),
                          got, want):
        _close(g, w, name=name)
    assert not got[4][2].any() and not got[5][2].any()


def test_non_pd_contract_matches_jax():
    """A KL anchor shrunk by 1e-12: W ≈ 2 kron(Mz, V')/β is indefinite where
    V' = −Cxx_T is; the factor fails, its NaN entries become the identity's,
    the flag rises, and the sanitized outputs (and any NaN they carry on) sit
    where JAX's are."""
    want = _jax_scan("2x1", 1e-12)
    got = _port_scan("2x1", 1e-12)
    param, value, div = got[4]
    np.testing.assert_array_equal(div.numpy(), want[4][2])
    assert div.all()
    _close(tuple(param), tuple(want[4][0]), name="param")
    _close(tuple(value), tuple(want[4][1]), name="value")


def test_unguarded_cholesky_contract():
    """A failed pivot at column j: NaN in the lower-right block from column j
    on, zeros above the diagonal (unrolled_linalg.chol_unrolled)."""
    M = torch.tensor([[4.0, 2.0, 0.0], [2.0, 0.5, 1.0], [0.0, 1.0, 5.0]], dtype=torch.float64)
    L = tc._chol(M)
    assert L[0, 0] == 2.0 and L[1, 0] == 1.0 and L[2, 0] == 0.0
    assert all(torch.isnan(L[i, j]) for i, j in ((1, 1), (2, 1), (2, 2)))
    assert (L.triu(1) == 0).all()
    Lp, _ = cr._chol_nan(M[None])
    assert torch.equal(torch.isnan(Lp[0]), torch.isnan(L))


class TestRgpsPinsPort:
    """``tests/goldens/rgps_pins.npz`` (T=9, dx=3, du=2) with the calls and
    tolerances of tests/test_goldens.py:134-200."""

    @pytest.fixture(scope="class")
    def rp(self):
        return np.load(GOLDENS)

    def _inputs(self, rp):
        T, p, dx = rp["in_A"].shape[0], rp["in_theta"].shape[-1], rp["in_A"].shape[-1]
        du = rp["in_K"].shape[-2]
        nominal = tt.MatrixNormalParams(mu=_t(rp["in_theta"]),
                                        sigma=_t(np.broadcast_to(1e-3 * np.eye(p), (T, p, p))))
        ctl = tt.LinearGaussianPolicy(K=_t(rp["in_K"]), kff=_t(rp["in_kff"]),
                                      sigma=_t(np.broadcast_to(np.eye(du), (T, du, du))))
        noise = _t(np.broadcast_to(1e-4 * np.eye(dx), (T, dx, dx)))
        cost = tt.QuadraticCost(*[_t(rp[f"in_{k}"]) for k in
                                  ["Cxx", "cx", "Cuu", "cu", "Cxu", "c0"]])
        return nominal, ctl, noise, cost, T, dx

    def test_cubature_pin(self, rp):
        nominal, ctl, noise, _, T, dx = self._inputs(rp)
        xdist, udist, _ = tc.cubature_forward_pass(_t(rp["in_mu0"]), _t(0.01 * np.eye(dx)),
                                                   nominal, noise, ctl)
        np.testing.assert_allclose(xdist.mu.numpy(), rp["cub_mu"], rtol=1e-10, atol=1e-12)
        np.testing.assert_allclose(xdist.sigma.numpy(), rp["cub_sigma"], rtol=1e-10, atol=1e-13)
        np.testing.assert_allclose(udist.mu.numpy(), rp["cub_umu"], rtol=1e-10, atol=1e-12)

    def test_adversary_pin(self, rp):
        nominal, ctl, noise, cost, T, dx = self._inputs(rp)
        xdist = tt.GaussianSequence(mu=_t(rp["cub_mu"]), sigma=_t(rp["cub_sigma"]))
        agCpp, agcp, _ = tc.parameter_augment_cost(nominal, torch.tensor(100.0,
                                                                          dtype=torch.float64))
        param, _, div = tc.parameter_backward_pass(xdist, ctl, noise, cost, agCpp, agcp,
                                                   torch.tensor(200.0, dtype=torch.float64))
        assert not bool(div)
        np.testing.assert_allclose(param.mu.numpy(), rp["adv_mu"], rtol=1e-9, atol=1e-11)
        np.testing.assert_allclose(param.sigma.numpy(), rp["adv_sigma"], rtol=1e-9, atol=1e-12)

    def test_policy_pin(self, rp):
        nominal, ctl, noise, cost, T, dx = self._inputs(rp)
        lgc, _, div = tc.policy_backward_pass(cost, nominal, noise,
                                              torch.full((T,), 10.0, dtype=torch.float64))
        assert not bool(div)
        np.testing.assert_allclose(lgc.K.numpy(), rp["pol_K"], rtol=1e-9, atol=1e-11)
        np.testing.assert_allclose(lgc.kff.numpy(), rp["pol_kff"], rtol=1e-9, atol=1e-11)


def _fp_problem(N, T, seed, anchor=1.0, kick=None):
    """Packed fixed-point operands of ``_problem`` (dims 2/1) with the
    marginal q0 the cubature under the nominal, optionally kicked per row."""
    pr = _problem(N, T, 2, 1, seed, anchor)
    cost, ctl, nom, noise, mu0, sigma0, beta = _containers(pr, tt, _t)
    agCpp, agcp, _ = tc.parameter_augment_cost(nom, beta)
    agCpp, agcp = anchor * agCpp, anchor * agcp
    xdist0, _, _ = tc.cubature_forward_pass(mu0, sigma0, nom, noise, ctl)
    if kick is not None:
        k = torch.as_tensor(kick)[:, None, None]
        xdist0 = tt.GaussianSequence(mu=xdist0.mu + 0.3 * k, sigma=xdist0.sigma * (1.0 + k[..., None]))
    return (agCpp, agcp, ctl, cost, xdist0, beta, mu0, sigma0, noise)


def _to_jax(args):
    return jax.tree.map(lambda x: jnp.asarray(x.numpy()), args,
                        is_leaf=lambda x: isinstance(x, torch.Tensor))


@reference(__file__)
def _pallas_ref(N, T, seed, anchor):
    """Interpret-mode K15 then K16 (on K15's θ*) with the packing of
    tests/test_pallas_rgps.py."""
    from trajopt_tpu.core import pallas_rgps as jp
    from trajopt_tpu.core.pallas_lqr import _from_lanes

    agCpp, agcp, ctl, cost, xdist0, beta, mu0, sigma0, noise = _to_jax(
        _fp_problem(N, T, seed, anchor))
    ctl, cost, xdist0 = (jt.LinearGaussianPolicy(*ctl), jt.QuadraticCost(*cost),
                         jt.GaussianSequence(*xdist0))
    n_pad = jp._pad_geom(N)[0]
    packed = jp.pack_rgps_problem(cost, ctl, noise, agCpp, agcp, beta)
    qmu, qsig, qmuT, qsigT = jp.pack_rgps_xdist(xdist0, n_pad)
    muopt, sigopt, bad = jp.rgps_param_backward_packed(packed, qmu, qsig, 2, 1, interpret=True)
    mu0_l = jp._to_lanes(mu0[:, None], n_pad)[0]
    sig0_l = jp._to_lanes(sigma0[:, None], n_pad)[0]
    kl, qnmu, qnsig, klT, qnmuT, qnsigT = jp.rgps_cubature_kl_packed(
        packed, muopt, sigopt, qmu, qsig, qmuT, qsigT, mu0_l, sig0_l, 2, 1, interpret=True)
    kl = jnp.concatenate([_from_lanes(kl, N, (1,))[:, :, 0], klT.reshape(1, -1).T[:N]], axis=1)
    q = jp.unpack_rgps_xdist(qnmu, qnsig, qnmuT, qnsigT, N, 2)
    return (_from_lanes(muopt, N, (8,)), _from_lanes(sigopt, N, (8, 8)), bad.reshape(-1)[:N] > 0,
            kl, q.mu, q.sigma)


def _port_trip(args):
    agCpp, agcp, ctl, cost, xdist0, beta, mu0, sigma0, noise = args
    packed = cr.pack_rgps_problem(cost, ctl, noise, agCpp, agcp, beta, mu0, sigma0)
    qmu, qsig = cr.pack_rgps_xdist(xdist0)
    muopt, sigopt, bad = cr.cuda_rgps_param_backward(packed, qmu, qsig)
    kl, qnmu, qnsig = cr.cuda_rgps_cubature_kl(packed, muopt, sigopt, qmu, qsig)
    param = cr.unpack_rgps_param(muopt, sigopt)
    q = cr.unpack_rgps_xdist(qnmu, qnsig)
    return param.mu, param.sigma, bad, kl.T, q.mu, q.sigma


def test_k15_k16_plain_match_pallas_interpret():
    got = _port_trip(_fp_problem(3, 5, 0))
    want = _pallas_ref(3, 5, 0, 1.0)
    np.testing.assert_allclose(got[0].numpy(), want[0], rtol=1e-9, atol=1e-11)
    np.testing.assert_allclose(got[1].numpy(), want[1], rtol=1e-9, atol=1e-13)
    np.testing.assert_array_equal(got[2].numpy(), want[2])
    np.testing.assert_allclose(got[3].numpy(), want[3], rtol=1e-8, atol=1e-12)
    np.testing.assert_allclose(got[4].numpy(), want[4], rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(got[5].numpy(), want[5], rtol=1e-9, atol=1e-14)
    assert cr.cuda_rgps_param_backward.launches == cr.cuda_rgps_cubature_kl.launches == 0


def test_k15_plain_flags_non_pd_as_pallas():
    """tests/test_pallas_rgps.py:116: a collapsed anchor flags every row, as
    the scan path does."""
    got = _port_trip(_fp_problem(2, 4, 3, anchor=1e-12))
    want = _pallas_ref(2, 4, 3, 1e-12)
    np.testing.assert_array_equal(got[2].numpy(), want[2])
    assert got[2].all()


def test_k15_plain_matches_scan_at_p28():
    """Robot's dims (4, 2): the 28 × 28 precision, K15's plain version
    against ``parameter_backward_pass``."""
    cost, ctl, nom, noise, mu0, sigma0, beta = _containers(_problem(2, 3, 4, 2, 5), tt, _t)
    agCpp, agcp, _ = tc.parameter_augment_cost(nom, beta)
    xdist0, _, _ = tc.cubature_forward_pass(mu0, sigma0, nom, noise, ctl)
    param, _, div = tc.parameter_backward_pass(xdist0, ctl, noise, cost, agCpp, agcp, beta)
    got = _port_trip((agCpp, agcp, ctl, cost, xdist0, beta, mu0, sigma0, noise))
    np.testing.assert_allclose(got[0].numpy(), param.mu.numpy(), rtol=1e-9, atol=1e-11)
    np.testing.assert_allclose(got[1].numpy(), param.sigma.numpy(), rtol=1e-9, atol=1e-13)
    np.testing.assert_array_equal(got[2].numpy(), div.numpy())


KICK = [0.0, 0.5, 2.0]


@reference(__file__)
def _jax_fixed_point(N, T, seed, fp_iters):
    """tests/test_pallas_rgps.py:180-271's vmapped per-instance while loop."""
    agCpp, agcp, ctl, cost, xdist0, beta, mu0, sigma0, noise = _to_jax(
        _fp_problem(N, T, seed, kick=KICK))
    ctl, cost, xdist0 = (jt.LinearGaussianPolicy(*ctl), jt.QuadraticCost(*cost),
                         jt.GaussianSequence(*xdist0))
    p = agCpp.shape[-1]

    def one(agCpp, agcp, ctl, cost, xdist0, beta, mu0, sigma0, noise):
        dummy = jt.MatrixNormalParams(mu=jnp.zeros((T, p)), sigma=jnp.tile(jnp.eye(p), (T, 1, 1)))

        def cond(state):
            q, param, kl, diverged, it = state
            return jnp.any(kl > 1e-3) & ~diverged & (it < fp_iters)

        def body(state):
            q, _, _, _, it = state
            param, _, diverged = jc.parameter_backward_pass(q, ctl, noise, cost, agCpp, agcp,
                                                            beta)
            p_xdist, _, _ = jc.cubature_forward_pass(mu0, sigma0, param, noise, ctl)
            return (js.gaussian_interp_kl(q, p_xdist, 1e-1), param,
                    js.gaussian_kl(p_xdist, q), diverged, it + 1)

        init = (xdist0, dummy, jnp.full(T + 1, jnp.inf), jnp.asarray(False), jnp.asarray(0))
        q, param, _, diverged, it = jax.lax.while_loop(cond, body, init)
        return q, param, diverged, it

    return jax.jit(jax.vmap(one))(agCpp, agcp, ctl, cost, xdist0, beta, mu0, sigma0, noise)


@pytest.mark.parametrize("group", [None, 1])
def test_fixed_point_freeze_semantics_match_vmapped_while(group):
    """Rows converge after different trip counts.  One group (the masking of q and the
    trip counter in ``pallas_rgps_fixed_point``) and one group per row (the
    solver's instances) both land on the vmapped while loop's fixed point
    at tests/test_pallas_rgps.py:257-265's tolerances."""
    q_r, param_r, div_r, it_r = _jax_fixed_point(3, 4, 2, 12)
    assert len(set(it_r.tolist())) > 1
    cr.cuda_rgps_fixed_point.trips = cr.cuda_rgps_fixed_point.syncs = 0
    q, param, div = cr.cuda_rgps_fixed_point(*_fp_problem(3, 4, 2, kick=KICK), fp_iters=12,
                                             group=group)
    np.testing.assert_array_equal(div.numpy(), div_r)
    np.testing.assert_allclose(q.mu.numpy(), q_r.mu, rtol=1e-7, atol=1e-10)
    np.testing.assert_allclose(q.sigma.numpy(), q_r.sigma, rtol=1e-7, atol=1e-12)
    np.testing.assert_allclose(param.mu.numpy(), param_r.mu, rtol=1e-7, atol=1e-9)
    np.testing.assert_allclose(param.sigma.numpy(), param_r.sigma, rtol=1e-7, atol=1e-12)
    trips = cr.cuda_rgps_fixed_point.trips
    assert trips == max(it_r) and cr.cuda_rgps_fixed_point.syncs == trips + 1


@reference(__file__)
def _robot_ref():
    env = trajopt_tpu.make("Robot-TO-v0")
    x, u, ul, w = _robot_samples()
    return (jax.vmap(env.dynamics)(x, u), jax.vmap(env.cost)(x, u, ul, w),
            jax.vmap(jax.jacfwd(env.dynamics, argnums=(0, 1)))(x, u))


def _robot_samples():
    rng = np.random.default_rng(4)
    return (np.asarray([5.0, 5.0, 0.3, 1.0]) + rng.standard_normal((5, 4)),
            rng.standard_normal((5, 2)), rng.standard_normal((5, 2)), rng.uniform(0.5, 1.5, 5))


def test_robot_matches_jax_and_kernel_engines_refuse_it():
    from trajopt_torch.parallel.elqr import make_elqr_solver_batched
    from trajopt_torch.parallel.mpc import make_ilqr_solver_batched

    env = trajopt_torch.make("Robot-TO-v0")
    assert dataclasses.asdict(env) == dataclasses.asdict(trajopt_tpu.make("Robot-TO-v0"))
    x, u, ul, w = (_t(a) for a in _robot_samples())
    xn, c, (jx, ju) = _robot_ref()
    _close(env.dynamics(x, u), xn)
    _close(env.cost(x, u, ul, w), c)
    _close(torch.func.vmap(torch.func.jacfwd(env.dynamics, argnums=(0, 1)))(x, u), (jx, ju))
    assert not env.supports_tiles and not env.supports_tile_quadratization
    for backward, rollout in (("cuda-fused", "scan"), ("scan", "cuda")):
        with pytest.raises(ValueError):
            make_ilqr_solver_batched(env, 8, backward=backward, rollout=rollout, device="cpu")
    for engine in ("cuda", "cuda-fused"):
        with pytest.raises(ValueError):
            make_elqr_solver_batched(env, 8, engine=engine, device="cpu")


def test_every_kernel_source_is_built():
    """``_build.SOURCES`` does not glob: every ``csrc/*.cu`` (rgps.cu with
    K15/K16 among them) must be listed, or ``build()`` leaves it out."""
    from trajopt_torch.kernels import _build

    assert set(_build.SOURCES) == {p.name for p in _build.CSRC.glob("*.cu")}
    assert "rgps.cu" in _build.SOURCES


@pytest.mark.parametrize("source", sorted(_build.SOURCES))
def test_kernel_headers_lie_in_csrc(source):
    """Each source's quoted includes (rgps.cu's pivot.cuh and ring.cuh among
    them) are files of ``csrc``, whose headers the build hashes into every
    library's name, so an edited header rebuilds its kernels."""
    text = (_build.CSRC / source).read_text()
    headers = re.findall(r'#include "([^"]+)"', text)
    assert all((_build.CSRC / h).is_file() for h in headers), headers
    assert all(h.endswith(".cuh") for h in headers)


@pytest.mark.parametrize("kernel", ["K15", "K16"])
def test_rgps_wrappers_refuse_non_cuda_devices(kernel):
    """A tensor on neither the CPU nor a CUDA device (here: meta) is refused
    before any build or launch; no fallback to the plain version."""
    T, dx, du, N = 3, 2, 1, 1
    p = dx * (dx + du + 1)
    z = lambda *s: torch.zeros(*s, device="meta")  # noqa: E731
    shapes = dict(cxx=(T, dx * dx, N), cx=(T, dx, N), cuu=(T, du * du, N), cu=(T, du, N),
                  cxu=(T, dx * du, N), c0=(T, 1, N), cuun=(T, du * du, N), acpp=(T, p * p, N),
                  acp=(T, p, N), sigd=(T, dx * dx, N), K=(T, du * dx, N), kff=(T, du, N),
                  sigc=(T, du * du, N), bpe=(N,), vT=(dx * dx, N), vvT=(dx, N), v0T=(1, N),
                  mu0=(dx, N), sig0=(dx * dx, N))
    packed = {k: z(*v) for k, v in shapes.items()}
    qmu, qsig = z(T + 1, dx, N), z(T + 1, dx * dx, N)
    launches = (cr.cuda_rgps_param_backward.launches, cr.cuda_rgps_cubature_kl.launches)
    with pytest.raises(ValueError, match="CUDA device"):
        if kernel == "K15":
            cr.cuda_rgps_param_backward(packed, qmu, qsig)
        else:
            cr.cuda_rgps_cubature_kl(packed, z(T, p, N), z(T, p * p, N), qmu, qsig)
    assert (cr.cuda_rgps_param_backward.launches, cr.cuda_rgps_cubature_kl.launches) == launches
