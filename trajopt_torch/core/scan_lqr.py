"""Sequential LQR kernels (counterpart of ``trajopt_tpu/core/scan_lqr.py``).

Python loops over time with batched small matrix products; any leading batch
dimensions run together.  The hot-path engines are the CUDA kernels
(``cuda_lqr``, ``cuda_fused``, ``cuda_gps``); these are the ``scan`` engines:

* :func:`ilqr_backward` — the regularized iLQR backward pass;
* :func:`gps_backward` — the soft-KL (−1/α-scaled) backward pass of GPS;
* :func:`gaussian_forward` — exact Gaussian propagation under a
  linear-Gaussian controller;
* :func:`augment_cost_kl`, :func:`policy_kl`, :func:`quad_expectation` — the
  rest of GPS's dual chain;
* :func:`gaussian_kl`, :func:`gaussian_interp_kl`, :func:`gaussian_interp_w2`
  — the per-step KL and the damping geodesics of robust GPS's adversary
  fixed point.
"""

from __future__ import annotations

import torch
from torch import Tensor

import math

from ..utils.psd import chol_solve, cholesky, inv_psd, logdet_psd
from .types import (
    GaussianSequence,
    LinearGaussianDynamics,
    LinearGaussianPolicy,
    LinearPolicy,
    QuadraticCost,
    QuadraticQValue,
    QuadraticValue,
    symmetrize,
)

_LOG_2PI = 1.8378770664093453  # log(2π)


def _mv(M: Tensor, x: Tensor) -> Tensor:
    return (M @ x.unsqueeze(-1)).squeeze(-1)


def _guarded_cholesky(S: Tensor) -> tuple[Tensor, Tensor]:
    """JAX's ``jnp.linalg.cholesky`` contract (a failed factorization is all
    NaN) followed by the scan path's guard: non-finite entries are replaced by
    the identity's, so a failure poisons only the flag, not the carry."""
    L = cholesky(S)
    finite = torch.isfinite(L)
    eye = torch.eye(S.shape[-1], dtype=S.dtype, device=S.device)
    return torch.where(finite, L, eye), ~finite.all(dim=(-2, -1))


def ilqr_backward(
    cost: QuadraticCost, A: Tensor, B: Tensor, lmbda: Tensor, reg: int,
) -> tuple[LinearPolicy, QuadraticValue, QuadraticQValue, Tensor, Tensor]:
    """Regularized iLQR backward pass (ilqr/src/util.cpp:83-182).

    ``cost`` stacks have T+1 steps (slice T is the terminal cost), ``A (..., T,
    dx, dx)``, ``B (..., T, dx, du)``, ``lmbda (...)``.  ``reg == 1`` adds λI to
    Quu; ``reg == 2`` adds λI to the value Hessian.  Returns (policy, value,
    qvalue, dV (..., 2), diverged (...) bool) where dV = Σ_t [kffᵀqu,
    ½ kffᵀ Quu kff].
    """
    if reg not in (1, 2):
        raise ValueError(f"reg must be 1 or 2, got {reg}")
    T, dx, du = A.shape[-3], A.shape[-1], B.shape[-1]
    lead = A.shape[:-3]
    lam = torch.as_tensor(lmbda, dtype=A.dtype, device=A.device)[..., None, None]
    eye_x = torch.eye(dx, dtype=A.dtype, device=A.device)
    eye_u = torch.eye(du, dtype=A.dtype, device=A.device)

    V, v = cost.Cxx[..., T, :, :], cost.cx[..., T, :]
    V_T, v_T = V, v
    dV = torch.zeros(*lead, 2, dtype=A.dtype, device=A.device)
    bad = torch.zeros(lead, dtype=torch.bool, device=A.device)
    outs = []
    for t in reversed(range(T)):
        Cxx, cx = cost.Cxx[..., t, :, :], cost.cx[..., t, :]
        Cuu, cu, Cxu = cost.Cuu[..., t, :, :], cost.cu[..., t, :], cost.Cxu[..., t, :, :]
        At, Bt = A[..., t, :, :], B[..., t, :, :]
        AT, BT = At.mT, Bt.mT

        Qxx = Cxx + AT @ V @ At
        Quu = Cuu + BT @ V @ Bt
        Qux = (Cxu + AT @ V @ Bt).mT
        qu = cu + _mv(BT, v)
        qx = cx + _mv(AT, v)

        V_reg = V + lam * eye_x if reg == 2 else V
        Qux_reg = (Cxu + AT @ V_reg @ Bt).mT
        Quu_reg = Cuu + BT @ V_reg @ Bt
        if reg == 1:
            Quu_reg = Quu_reg + lam * eye_u

        chol, step_bad = _guarded_cholesky(symmetrize(Quu_reg))
        K = -torch.cholesky_solve(Qux_reg, chol)
        kff = -torch.cholesky_solve(qu.unsqueeze(-1), chol).squeeze(-1)

        dV = dV + torch.stack(
            [(kff * qu).sum(-1), (0.5 * kff * _mv(Quu, kff)).sum(-1)], dim=-1
        )
        KT = K.mT
        v = qx + _mv(KT @ Quu, kff) + _mv(KT, qu) + _mv(Qux.mT, kff)
        V = symmetrize(Qxx + KT @ Quu @ K + KT @ Qux + Qux.mT @ K)
        bad = bad | step_bad
        outs.append((K, kff, V, v, Qxx, Quu, Qux, qx, qu))

    # time axis right after the batch dimensions, forward order
    K, kff, Vs, vs, Qxx, Quu, Qux, qx, qu = (
        torch.stack(seq[::-1], dim=len(lead)) for seq in zip(*outs)
    )
    zeros_T = torch.zeros(*lead, T, dtype=A.dtype, device=A.device)
    value = QuadraticValue(
        V=torch.cat([Vs, V_T.unsqueeze(-3)], dim=-3),
        v=torch.cat([vs, v_T.unsqueeze(-2)], dim=-2),
        v0=torch.zeros(*lead, T + 1, dtype=A.dtype, device=A.device),
    )
    qvalue = QuadraticQValue(Qxx=Qxx, Quu=Quu, Qux=Qux, qx=qx, qu=qu, q0=zeros_T)
    return LinearPolicy(K=K, kff=kff), value, qvalue, dV, bad


# --------------------------------------------------------------------------------------
# GPS (soft-KL backward, absolute convention) and its dual chain
# --------------------------------------------------------------------------------------


def _trace(M: Tensor) -> Tensor:
    return torch.diagonal(M, dim1=-2, dim2=-1).sum(-1)


def _dot(x: Tensor, y: Tensor) -> Tensor:
    return (x * y).sum(-1)


def gps_backward(
    agcost: QuadraticCost, dyn: LinearGaussianDynamics, alpha: Tensor,
) -> tuple[LinearGaussianPolicy, QuadraticValue, QuadraticQValue, Tensor]:
    """Soft-KL Riccati pass producing a stochastic controller
    (gps/src/util.cpp:272-374).

    Q-blocks are scaled by −1/α(t), so −Quu must be positive definite; the
    controller is K = −Quu⁻¹Qux, kff = −½Quu⁻¹qu, Σ_ctl = −½Quu⁻¹.  ``agcost``
    stacks have T+1 steps, ``alpha (..., T)``.  A failed factorization of −Quu
    (``jnp.linalg.cholesky``'s NaN) flags divergence and continues with the
    identity factor; v0 then goes NaN through log det.  Returns (policy, value
    (T+1), qvalue, diverged (...) bool).
    """
    T, du = dyn.horizon, dyn.B.shape[-1]
    lead = dyn.A.shape[:-3]
    dt, dev = dyn.A.dtype, dyn.A.device
    eye_u = torch.eye(du, dtype=dt, device=dev)
    V, v, v0 = agcost.Cxx[..., T, :, :], agcost.cx[..., T, :], agcost.c0[..., T]
    V_T, v_T, v0_T = V, v, v0
    bad = torch.zeros(lead, dtype=torch.bool, device=dev)
    outs = []
    for t in reversed(range(T)):
        Cxx, cx, c0 = agcost.Cxx[..., t, :, :], agcost.cx[..., t, :], agcost.c0[..., t]
        Cuu, cu, Cxu = agcost.Cuu[..., t, :, :], agcost.cu[..., t, :], agcost.Cxu[..., t, :, :]
        A, B = dyn.A[..., t, :, :], dyn.B[..., t, :, :]
        c, sig = dyn.c[..., t, :], dyn.sigma[..., t, :, :]
        a = alpha[..., t]
        am = a[..., None, None]
        AT, BT = A.mT, B.mT

        Qxx = -(Cxx + AT @ V @ A) / am
        Quu = -(Cuu + BT @ V @ B) / am
        Qux = -(Cxu + AT @ V @ B).mT / am
        qu = -(cu + _mv(2.0 * BT @ V, c) + _mv(BT, v)) / a[..., None]
        qx = -(cx + _mv(2.0 * AT @ V, c) + _mv(AT, v)) / a[..., None]
        q0 = -(c0 + v0 + _dot(_mv(V.mT, c), c) + _trace(V @ sig) + _dot(v, c)) / a

        neg_chol = cholesky(-symmetrize(Quu))
        finite = torch.isfinite(neg_chol)
        safe = torch.where(finite, neg_chol, eye_u)
        bad = bad | ~finite.all(dim=(-2, -1))

        K = chol_solve(safe, Qux)
        kff = 0.5 * chol_solve(safe, qu)
        sigma_ctl = symmetrize(0.5 * chol_solve(safe, eye_u.expand(safe.shape)))

        V = symmetrize(-am * (Qxx + Qux.mT @ K))
        v = -a[..., None] * (qx + _mv(2.0 * Qux.mT, kff))
        logdet_m2Quu = du * math.log(2.0) + 2.0 * torch.log(
            torch.diagonal(neg_chol, dim1=-2, dim2=-1)).sum(-1)
        v0 = -a * (0.5 * _dot(qu, kff) + q0 + 0.5 * (du * _LOG_2PI - logdet_m2Quu))
        outs.append((K, kff, sigma_ctl, V, v, v0, Qxx, Quu, Qux, qx, qu, q0))

    K, kff, sigma_ctl, Vs, vs, v0s, Qxx, Quu, Qux, qx, qu, q0 = (
        torch.stack(seq[::-1], dim=len(lead)) for seq in zip(*outs)
    )
    value = QuadraticValue(
        V=torch.cat([Vs, V_T.unsqueeze(-3)], dim=-3),
        v=torch.cat([vs, v_T.unsqueeze(-2)], dim=-2),
        v0=torch.cat([v0s, v0_T.unsqueeze(-1)], dim=-1),
    )
    qvalue = QuadraticQValue(Qxx=Qxx, Quu=Quu, Qux=Qux, qx=qx, qu=qu, q0=q0)
    return LinearGaussianPolicy(K=K, kff=kff, sigma=sigma_ctl), value, qvalue, bad


def gaussian_forward(
    dyn: LinearGaussianDynamics, policy: LinearGaussianPolicy, mu0: Tensor, sigma0: Tensor,
) -> tuple[GaussianSequence, GaussianSequence, GaussianSequence]:
    """Exact propagation of the (x, u, xu) joint through linear-Gaussian
    dynamics and controller (gps/src/util.cpp:195-269).

    Returns (xdist: T+1, udist: T, xudist: T+1); the terminal xu entry holds
    the terminal state marginal with a zero action block.
    """
    T, dx, du = dyn.horizon, dyn.A.shape[-1], dyn.B.shape[-1]
    mu_x, sigma_x = mu0, sigma0
    outs = []
    for t in range(T):
        A, B = dyn.A[..., t, :, :], dyn.B[..., t, :, :]
        c, sig_dyn = dyn.c[..., t, :], dyn.sigma[..., t, :, :]
        K, kff, sig_ctl = policy.K[..., t, :, :], policy.kff[..., t, :], policy.sigma[..., t, :, :]
        mu_u = _mv(K, mu_x) + kff
        sigma_u = symmetrize(sig_ctl + K @ sigma_x @ K.mT)
        cross = sigma_x @ K.mT
        sigma_xu = symmetrize(torch.cat([torch.cat([sigma_x, cross], dim=-1),
                                         torch.cat([cross.mT, sigma_u], dim=-1)], dim=-2))
        mu_xu = torch.cat([mu_x, mu_u], dim=-1)
        AB = torch.cat([A, B], dim=-1)
        outs.append((mu_x, sigma_x, mu_u, sigma_u, mu_xu, sigma_xu))
        sigma_x = symmetrize(sig_dyn + AB @ sigma_xu @ AB.mT)
        mu_x = _mv(AB, mu_xu) + c

    axis = mu0.dim() - 1
    mus_x, sigmas_x, mus_u, sigmas_u, mus_xu, sigmas_xu = (
        torch.stack(seq, dim=axis) for seq in zip(*outs)
    )
    mu_xu_T = torch.cat([mu_x, torch.zeros_like(mu_x[..., :du])], dim=-1)
    sigma_xu_T = torch.zeros(*sigma_x.shape[:-2], dx + du, dx + du,
                             dtype=sigma_x.dtype, device=sigma_x.device)
    sigma_xu_T[..., :dx, :dx] = sigma_x
    return (
        GaussianSequence(mu=torch.cat([mus_x, mu_x.unsqueeze(-2)], dim=-2),
                         sigma=torch.cat([sigmas_x, sigma_x.unsqueeze(-3)], dim=-3)),
        GaussianSequence(mu=mus_u, sigma=sigmas_u),
        GaussianSequence(mu=torch.cat([mus_xu, mu_xu_T.unsqueeze(-2)], dim=-2),
                         sigma=torch.cat([sigmas_xu, sigma_xu_T.unsqueeze(-3)], dim=-3)),
    )


def augment_cost_kl(
    cost: QuadraticCost, policy: LinearGaussianPolicy, alpha: Tensor
) -> QuadraticCost:
    """Fold the α-weighted KL(π‖π_old) penalty into the quadratic cost
    (gps/src/util.cpp:136-193); ``alpha (..., T)``.  The terminal slice passes
    through unchanged."""
    T, du = policy.horizon, policy.kff.shape[-1]
    K, kff, sig = policy.K, policy.kff, policy.sigma
    a = alpha[..., None]
    am = alpha[..., None, None]
    KT = K.mT
    lam = inv_psd(sig)
    agCxx = cost.Cxx[..., :T, :, :] + 0.5 * am * KT @ lam @ K
    agCuu = cost.Cuu[..., :T, :, :] + 0.5 * am * lam
    agCxu = cost.Cxu[..., :T, :, :] - 0.5 * am * KT @ lam
    agcx = cost.cx[..., :T, :] + _mv(a[..., None] * KT @ lam, kff)
    agcu = cost.cu[..., :T, :] - _mv(am * lam, kff)
    agc0 = (cost.c0[..., :T] + 0.5 * alpha * (du * _LOG_2PI + logdet_psd(sig))
            + _dot(_mv(lam.mT, 0.5 * a * kff), kff))

    return QuadraticCost(
        Cxx=torch.cat([agCxx, cost.Cxx[..., T:, :, :]], dim=-3),
        cx=torch.cat([agcx, cost.cx[..., T:, :]], dim=-2),
        Cuu=torch.cat([agCuu, cost.Cuu[..., T:, :, :]], dim=-3),
        cu=torch.cat([agcu, cost.cu[..., T:, :]], dim=-2),
        Cxu=torch.cat([agCxu, cost.Cxu[..., T:, :, :]], dim=-3),
        c0=torch.cat([agc0, cost.c0[..., T:]], dim=-1),
    )


def policy_kl(
    p: LinearGaussianPolicy, q: LinearGaussianPolicy, xdist: GaussianSequence
) -> Tensor:
    """Per-step KL(p‖q) between linear-Gaussian policies under the state
    marginal (gps/src/util.cpp:83-121); returns ``(..., T)``."""
    T, du = p.horizon, p.kff.shape[-1]
    mu, sig = xdist.mu[..., :T, :], xdist.sigma[..., :T, :, :]
    q_lam = inv_psd(q.sigma)
    dK = q.K - p.K
    dk = p.kff - q.kff
    diff_K = dK.mT @ q_lam @ dK
    diff_crs = _mv(dK.mT @ q_lam, dk)
    diff_kff = _dot(_mv(q_lam.mT, dk), dk)
    return (
        0.5 * (logdet_psd(q.sigma) - logdet_psd(p.sigma))
        + 0.5 * _trace(q_lam @ p.sigma)
        - 0.5 * du
        + 0.5 * _trace(diff_K @ sig)
        + 0.5 * _dot(_mv(diff_K.mT, mu), mu)
        - _dot(mu, diff_crs)
        + 0.5 * diff_kff
    )


def quad_expectation(mu: Tensor, sigma: Tensor, V: Tensor, v: Tensor, v0: Tensor) -> Tensor:
    """E[xᵀVx + vᵀx + v0] under N(mu, sigma) (gps/src/util.cpp:123-134)."""
    return _dot(_mv(V.mT, mu), mu) + _dot(mu, v) + v0 + _trace(V @ sigma)


def gaussian_kl(p: GaussianSequence, q: GaussianSequence) -> Tensor:
    """Per-step KL(p‖q) between Gaussian sequences (rgps/src/util.cpp:125-152);
    ``(..., T, d)`` means → ``(..., T)``."""
    d = p.mu.shape[-1]
    lam_q = inv_psd(q.sigma)
    diff = q.mu - p.mu
    return 0.5 * (_trace(lam_q @ p.sigma) + _dot(_mv(lam_q.mT, diff), diff)
                  + logdet_psd(q.sigma) - logdet_psd(p.sigma) - d)


def gaussian_interp_kl(q: GaussianSequence, p: GaussianSequence, a: float) -> GaussianSequence:
    """Precision-weighted (KL-geodesic) interpolation (rgps/src/util.cpp:188-215):
    Σ = (aΛ_p + (1−a)Λ_q)⁻¹, μ = Σ(aΛ_p μ_p + (1−a)Λ_q μ_q)."""
    lam_q, lam_p = inv_psd(q.sigma), inv_psd(p.sigma)
    sigma = inv_psd(a * lam_p + (1.0 - a) * lam_q)
    mu = _mv(sigma, _mv(a * lam_p, p.mu) + _mv((1.0 - a) * lam_q, q.mu))
    return GaussianSequence(mu=mu, sigma=sigma)


def _sqrtm(M: Tensor) -> Tensor:
    """Symmetric square root through the eigendecomposition, eigenvalues
    clamped at 0 (Armadillo's ``sqrtmat`` on SPD inputs)."""
    w, U = torch.linalg.eigh(symmetrize(M))
    return (U * torch.sqrt(torch.clamp(w, min=0.0)).unsqueeze(-2)) @ U.mT


def gaussian_interp_w2(q: GaussianSequence, p: GaussianSequence, a: float) -> GaussianSequence:
    """Wasserstein-2 geodesic interpolation (rgps/src/util.cpp:155-185)."""
    mu = (1.0 - a) * q.mu + a * p.mu
    s_q = _sqrtm(q.sigma)
    s_q_inv = inv_psd(s_q)
    mid = (1.0 - a) * q.sigma + a * _sqrtm(s_q @ p.sigma @ s_q)
    return GaussianSequence(mu=mu, sigma=s_q_inv @ mid @ mid @ s_q_inv)
