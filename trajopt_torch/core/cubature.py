"""Robust GPS's scan kernels (counterpart of ``trajopt_tpu/core/cubature.py``).

* :func:`cubature_forward_pass` — propagate the state marginal through
  uncertain linear dynamics θ = vec([A B c]) ~ MN(μθ, Σθ) with 2·daug
  cubature points over the augmented (x, u, 1, noise) space
  (rgps/src/util.cpp:232-361);
* :func:`policy_backward_pass` — GPS's soft-KL backward pass with the
  parameter-uncertainty corrections P(a, b) = tr(Σθ_block · V')
  (util.cpp:424-563);
* :func:`parameter_augment_cost` — the β·KL-to-reference penalty, quadratic
  in θ (util.cpp:566-624);
* :func:`parameter_backward_pass` — the adversary's optimal MatrixNormal per
  step, W = 2(agCpp + kron(Mz, V'))/(β+η), Σθ* = W⁻¹, μθ* = Σθ* w, with the
  maximizing player's value recursion through A + BK (util.cpp:626-798).

Python loops over time; any leading batch dimensions run together.  The
factorizations keep the JAX package's unguarded contract: :func:`_chol` is
the column-by-column Cholesky whose failed pivot at column j leaves NaN in
the lower-right block from column j on and zeros above the diagonal, and the
backward passes sanitize that factor entrywise (NaN → the identity's entry)
and raise the ``diverged`` flag.  ``torch.linalg.cholesky`` raises and
``cholesky_ex`` returns a partial factor, so neither is used here.  Products
that may meet NaN factors are written as elementwise sums, so 0·NaN = NaN
propagates as it does in the reference.

θ-vec convention: column-major over [A B c], so Σθ viewed as a 4-tensor is
Σθ[a·dx+i, b·dx+j] = S4[a, i, b, j] with (a, b) column-block indices.
"""

from __future__ import annotations

import math

import torch
from torch import Tensor

from ..utils.psd import inv_psd, logdet_psd
from .scan_lqr import _dot, _mv, _trace
from .types import (
    GaussianSequence,
    LinearGaussianPolicy,
    MatrixNormalParams,
    QuadraticCost,
    QuadraticValue,
    matrices_from_vec,
    symmetrize,
)

_LOG_2PI = 1.8378770664093453


def _chol(M: Tensor) -> Tensor:
    """Lower Cholesky factor of ``M (..., n, n)``, column by column; a non-PD
    pivot gives NaN (sqrt of a negative number), never an exception."""
    n = M.shape[-1]
    L = torch.zeros_like(M)
    below = torch.arange(n, device=M.device)
    for j in range(n):
        r = M[..., :, j]
        if j:
            # columns >= j of L are still zero
            r = r - (L * L[..., j:j + 1, :]).sum(-1)
        d = torch.sqrt(r[..., j])
        L[..., :, j] = torch.where(below >= j, r / d.unsqueeze(-1), torch.zeros_like(r))
    return L


def _solve_lower(L: Tensor, B: Tensor) -> Tensor:
    """X with L X = B for lower-triangular ``L (..., n, n)``, ``B (..., n, m)``."""
    X = torch.zeros(torch.broadcast_shapes(L.shape[:-2], B.shape[:-2]) + B.shape[-2:],
                    dtype=B.dtype, device=B.device)
    for i in range(L.shape[-1]):
        xi = B[..., i, :]
        if i:
            xi = xi - (L[..., i, :].unsqueeze(-1) * X).sum(-2)
        X[..., i, :] = xi / L[..., i, i].unsqueeze(-1)
    return X


def _solve_upper_from_lower(L: Tensor, B: Tensor) -> Tensor:
    """X with Lᵀ X = B for lower-triangular ``L (..., n, n)``, ``B (..., n, m)``."""
    n = L.shape[-1]
    X = torch.zeros(torch.broadcast_shapes(L.shape[:-2], B.shape[:-2]) + B.shape[-2:],
                    dtype=B.dtype, device=B.device)
    for i in range(n - 1, -1, -1):
        xi = B[..., i, :]
        if i < n - 1:
            xi = xi - (L[..., :, i].unsqueeze(-1) * X).sum(-2)
        X[..., i, :] = xi / L[..., i, i].unsqueeze(-1)
    return X


def _chol_solve(L: Tensor, B: Tensor) -> Tensor:
    """X with (L Lᵀ) X = B; ``B`` a vector ``(..., n)`` or matrix ``(..., n, m)``."""
    vec = B.dim() == L.dim() - 1
    X = _solve_upper_from_lower(L, _solve_lower(L, B.unsqueeze(-1) if vec else B))
    return X.squeeze(-1) if vec else X


def _sanitize(L: Tensor) -> tuple[Tensor, Tensor]:
    """The factor with each non-finite entry replaced by the identity's, and
    whether any entry was non-finite (core/cubature.py:317-321)."""
    finite = torch.isfinite(L)
    eye = torch.eye(L.shape[-1], dtype=L.dtype, device=L.device)
    return torch.where(finite, L, eye), ~finite.all(dim=-1).all(dim=-1)


def _kron(M: Tensor, V: Tensor) -> Tensor:
    """Batched ``kron(M (..., a, b), V (..., i, j))`` → ``(..., a·i, b·j)``."""
    out = M[..., :, None, :, None] * V[..., None, :, None, :]
    return out.reshape(*out.shape[:-4], M.shape[-2] * V.shape[-2], M.shape[-1] * V.shape[-1])


def _trace_blocks(S4: Tensor, V: Tensor) -> Tensor:
    """P[a, b] = tr(Σθ_block[a, b] V) (util.cpp:494-507) as one contraction."""
    return torch.einsum("...aibj,...ji->...ab", S4, V)


def _eye(n: int, like: Tensor) -> Tensor:
    return torch.eye(n, dtype=like.dtype, device=like.device)


def _moments_xu(mu_x, sigma_x, K, kff, sig_ctl):
    """Action mean and covariance (jittered) and the state-action cross term."""
    mu_u = _mv(K, mu_x) + kff
    sigma_u = symmetrize(sig_ctl + K @ sigma_x @ K.mT) + 1e-8 * _eye(K.shape[-2], K)
    return mu_u, sigma_u, sigma_x @ K.mT


def _block2(a: Tensor, b: Tensor, c: Tensor, d: Tensor) -> Tensor:
    return torch.cat([torch.cat([a, b], dim=-1), torch.cat([c, d], dim=-1)], dim=-2)


def cubature_forward_pass(
    mu0: Tensor,
    sigma0: Tensor,
    param: MatrixNormalParams,
    sigma_dyn: Tensor,
    policy: LinearGaussianPolicy,
) -> tuple[GaussianSequence, GaussianSequence, GaussianSequence]:
    """Cubature propagation of the state marginal under uncertain dynamics
    (util.cpp:232-361).  ``mu0 (..., dx)``, ``param`` ``(..., T, p)`` /
    ``(..., T, p, p)``, ``sigma_dyn (..., T, dx, dx)``, ``policy (..., T, …)``.
    Returns (xdist T+1, udist T, xudist T+1)."""
    dx, du = mu0.shape[-1], policy.kff.shape[-1]
    T = policy.horizon
    p1, nxu = dx + du + 1, dx + du
    daug = nxu + 1 + dx
    n_pts = 2 * daug
    scale = math.sqrt(float(daug))
    jitter_xu = 1e-8 * _eye(nxu, mu0)
    lead = mu0.shape[:-1]
    unit = torch.eye(dx, dtype=mu0.dtype, device=mu0.device).expand(*lead, dx, dx)

    mu_x, sigma_x = mu0, sigma0
    mus_x, sigs_x, mus_u, sigs_u, mus_xu, sigs_xu = [], [], [], [], [], []
    for t in range(T):
        A, B, c = matrices_from_vec(param.mu[..., t, :], dx, du)
        S4 = param.sigma[..., t, :, :].reshape(*lead, p1, dx, p1, dx)
        K, kff = policy.K[..., t, :, :], policy.kff[..., t, :]
        mu_u, sigma_u, cross = _moments_xu(mu_x, sigma_x, K, kff, policy.sigma[..., t, :, :])
        sigma_xu = symmetrize(_block2(sigma_x, cross, cross.mT, sigma_u)) + jitter_xu
        mu_xu = torch.cat([mu_x, mu_u], dim=-1)

        # augmented sqrt-covariance [chol(Σxu) 0 0; 0 0 0; 0 0 I]
        chol_aug = torch.zeros(*lead, daug, daug, dtype=mu0.dtype, device=mu0.device)
        chol_aug[..., :nxu, :nxu] = _chol(sigma_xu)
        chol_aug[..., nxu + 1:, nxu + 1:] = unit
        mu_aug = torch.cat([mu_xu, torch.ones_like(mu_x[..., :1]), torch.zeros_like(mu_x)], -1)
        pts = mu_aug.unsqueeze(-2) + scale * torch.cat([chol_aug, -chol_aug], dim=-1).mT
        z, w = pts[..., :p1], pts[..., p1:]
        covs = symmetrize(sigma_dyn[..., t, None, :, :]
                          + torch.einsum("...na,...aibj,...nb->...nij", z, S4, z))
        # the unit-noise part: zero for the (x, u, 1) points, whose factor
        # still enters as 0·L (NaN when the factorization failed)
        noise = (_chol(covs) * w.unsqueeze(-2)).sum(-1)
        out = (_mv(A.unsqueeze(-3), z[..., :dx]) + _mv(B.unsqueeze(-3), z[..., dx:nxu])
               + z[..., nxu:nxu + 1] * c.unsqueeze(-2) + noise)
        mu_n = out.mean(-2)
        centered = out - mu_n.unsqueeze(-2)
        sigma_n = symmetrize(centered.mT @ centered / n_pts)

        mus_x.append(mu_x)
        sigs_x.append(sigma_x)
        mus_u.append(mu_u)
        sigs_u.append(sigma_u)
        mus_xu.append(mu_xu)
        sigs_xu.append(sigma_xu)
        mu_x, sigma_x = mu_n, sigma_n

    axis = len(lead)
    mu_xu_T = torch.cat([mu_x, torch.zeros_like(mus_u[0])], dim=-1)
    sigma_xu_T = torch.zeros_like(sigs_xu[0])
    sigma_xu_T[..., :dx, :dx] = sigma_x
    return (
        GaussianSequence(mu=torch.stack(mus_x + [mu_x], axis),
                         sigma=torch.stack(sigs_x + [sigma_x], axis)),
        GaussianSequence(mu=torch.stack(mus_u, axis), sigma=torch.stack(sigs_u, axis)),
        GaussianSequence(mu=torch.stack(mus_xu + [mu_xu_T], axis),
                         sigma=torch.stack(sigs_xu + [sigma_xu_T], axis)),
    )


def policy_backward_pass(
    agcost: QuadraticCost,
    param: MatrixNormalParams,
    sigma_dyn: Tensor,
    alpha: Tensor,
) -> tuple[LinearGaussianPolicy, QuadraticValue, Tensor]:
    """Soft-KL backward pass under parameter uncertainty (util.cpp:424-563).

    ``agcost`` stacks ``(..., T+1, …)``, ``param (..., T, …)``, ``sigma_dyn
    (..., T, dx, dx)``, ``alpha (..., T)``.  Returns (policy, value T+1,
    diverged); a non-PD −Quu sets the flag and its sanitized factor is used."""
    T, p = param.mu.shape[-2], param.mu.shape[-1]
    dx = sigma_dyn.shape[-1]
    p1 = p // dx
    du = p1 - dx - 1
    lead = param.mu.shape[:-2]
    eye_u = _eye(du, param.mu)

    V, v, v0 = agcost.Cxx[..., T, :, :], agcost.cx[..., T, :], agcost.c0[..., T]
    bad = torch.zeros(lead, dtype=torch.bool, device=param.mu.device)
    Ks, kffs, sigs, Vs, vs, v0s = [], [], [], [], [], []
    for t in range(T - 1, -1, -1):
        A, B, c = matrices_from_vec(param.mu[..., t, :], dx, du)
        P = _trace_blocks(param.sigma[..., t, :, :].reshape(*lead, p1, dx, p1, dx), V)
        Pxx, Puu, Pxu = P[..., :dx, :dx], P[..., dx:dx + du, dx:dx + du], P[..., :dx, dx:dx + du]
        px, pu, p0 = P[..., :dx, -1], P[..., dx:dx + du, -1], P[..., -1, -1]
        a = alpha[..., t]
        am = a[..., None, None]

        Qxx = -(agcost.Cxx[..., t, :, :] + A.mT @ V @ A + Pxx) / am
        Quu = -(agcost.Cuu[..., t, :, :] + B.mT @ V @ B + Puu) / am
        Qux = -(agcost.Cxu[..., t, :, :] + A.mT @ V @ B + Pxu).mT / am
        qu = -(agcost.cu[..., t, :] + 2.0 * _mv(B.mT @ V, c) + _mv(B.mT, v) + 2.0 * pu) / a[..., None]
        qx = -(agcost.cx[..., t, :] + 2.0 * _mv(A.mT @ V, c) + _mv(A.mT, v) + 2.0 * px) / a[..., None]
        q0 = -(agcost.c0[..., t] + v0 + _dot(_mv(V.mT, c), c) + _trace(V @ sigma_dyn[..., t, :, :])
               + _dot(v, c) + p0) / a

        safe, step_bad = _sanitize(_chol(-symmetrize(Quu)))
        K = _chol_solve(safe, Qux)
        kff = 0.5 * _chol_solve(safe, qu)
        sig_ctl = symmetrize(0.5 * _chol_solve(safe, eye_u.expand(safe.shape)))

        V = symmetrize(-am * (Qxx + Qux.mT @ K))
        v = -a[..., None] * (qx + 2.0 * _mv(Qux.mT, kff))
        logdet_m2Quu = du * math.log(2.0) + 2.0 * torch.log(
            torch.diagonal(safe, dim1=-2, dim2=-1)).sum(-1)
        v0 = -a * (0.5 * _dot(qu, kff) + q0 + 0.5 * (du * _LOG_2PI - logdet_m2Quu))
        bad = bad | step_bad
        Ks.append(K)
        kffs.append(kff)
        sigs.append(sig_ctl)
        Vs.append(V)
        vs.append(v)
        v0s.append(v0)

    axis = len(lead)

    def stack(xs, last=None):
        xs = xs[::-1] + ([] if last is None else [last])
        return torch.stack(xs, axis)

    value = QuadraticValue(V=stack(Vs, agcost.Cxx[..., T, :, :]), v=stack(vs, agcost.cx[..., T, :]),
                           v0=stack(v0s, agcost.c0[..., T]))
    return LinearGaussianPolicy(K=stack(Ks), kff=stack(kffs), sigma=stack(sigs)), value, bad


def parameter_augment_cost(reference: MatrixNormalParams, scale: Tensor):
    """The β·KL-to-reference penalty, quadratic in θ (util.cpp:566-624):
    Cpp = ½sΛ, cp = −sΛμ, c0 = ½s(log det 2πΣ + μᵀΛμ).  ``reference`` stacks
    ``(..., T, p)``, ``scale`` has the leading shape ``(...)``.  Returns
    (Cpp (..., T, p, p), cp (..., T, p), c0 (..., T))."""
    p = reference.mu.shape[-1]
    s = torch.as_tensor(scale, dtype=reference.mu.dtype, device=reference.mu.device)[..., None]
    lam = inv_psd(reference.sigma)
    lam_mu = _mv(lam, reference.mu)
    Cpp = 0.5 * s[..., None, None] * lam
    cp = -s[..., None] * lam_mu
    c0 = (0.5 * s * (p * _LOG_2PI + logdet_psd(reference.sigma))
          + 0.5 * s * _dot(_mv(lam.mT, reference.mu), reference.mu))
    return Cpp, cp, c0


def joint_moments(xdist: GaussianSequence, policy: LinearGaussianPolicy):
    """The (x, u, 1) mean and jittered covariance per step under the state
    marginal (util.cpp:661-686): ``(..., T, p1)``, ``(..., T, p1, p1)``."""
    T = policy.horizon
    mu_x, sigma_x = xdist.mu[..., :T, :], xdist.sigma[..., :T, :, :]
    dx, du = mu_x.shape[-1], policy.kff.shape[-1]
    mu_u, sigma_u, cross = _moments_xu(mu_x, sigma_x, policy.K, policy.kff, policy.sigma)
    sigma_z = torch.zeros(*mu_x.shape[:-1], dx + du + 1, dx + du + 1,
                          dtype=mu_x.dtype, device=mu_x.device)
    sigma_z[..., :dx + du, :dx + du] = _block2(sigma_x, cross, cross.mT, sigma_u)
    sigma_z = symmetrize(sigma_z) + 1e-8 * _eye(dx + du + 1, mu_x)
    return torch.cat([mu_x, mu_u, torch.ones_like(mu_x[..., :1])], dim=-1), sigma_z


def parameter_backward_pass(
    xdist: GaussianSequence,
    policy: LinearGaussianPolicy,
    sigma_dyn: Tensor,
    cost: QuadraticCost,
    agCpp: Tensor,
    agcp: Tensor,
    beta_plus_eta: Tensor,
) -> tuple[MatrixNormalParams, QuadraticValue, Tensor]:
    """The adversary's optimal MatrixNormal per step (util.cpp:626-798).

    W = 2(agCpp + kron(μzμzᵀ + Σz, V'))/(β+η), w = −(agcp + kron(μz, v'))/(β+η),
    Σθ* = W⁻¹ through the sanitized factor, μθ* = Σθ* w; the maximizer's value
    runs through the closed loop A + BK from V_T = −Cxx_T.  ``beta_plus_eta``
    has the leading shape ``(...)``.  Returns (param (..., T, …), value T+1,
    diverged (...))."""
    T = policy.horizon
    dx, du = sigma_dyn.shape[-1], policy.kff.shape[-1]
    p1 = dx + du + 1
    p = dx * p1
    lead = policy.kff.shape[:-2]
    mu_xu, sigma_xu = joint_moments(xdist, policy)
    bpe = torch.as_tensor(beta_plus_eta, dtype=agcp.dtype, device=agcp.device)
    eye_p = _eye(p, agcp)

    V, v, v0 = -cost.Cxx[..., T, :, :], -cost.cx[..., T, :], -cost.c0[..., T]
    bad = torch.zeros(lead, dtype=torch.bool, device=agcp.device)
    mus, sigmas, Vs, vs, v0s = [], [], [], [], []
    for t in range(T - 1, -1, -1):
        mu_z, sigma_z = mu_xu[..., t, :], sigma_xu[..., t, :, :]
        K, kff, sig_ctl = policy.K[..., t, :, :], policy.kff[..., t, :], policy.sigma[..., t, :, :]
        Cxx, cx, Cuu, cu = cost.Cxx[..., t, :, :], cost.cx[..., t, :], cost.Cuu[..., t, :, :], cost.cu[..., t, :]
        Cxu, c0, Cuu_next = cost.Cxu[..., t, :, :], cost.c0[..., t], cost.Cuu[..., t + 1, :, :]

        Vpp = _kron(mu_z.unsqueeze(-1) * mu_z.unsqueeze(-2) + sigma_z, V)
        vp = (mu_z.unsqueeze(-1) * v.unsqueeze(-2)).reshape(*lead, p)
        W = symmetrize(2.0 * (agCpp[..., t, :, :] + Vpp) / bpe[..., None, None])
        w = -(agcp[..., t, :] + vp) / bpe[..., None]

        safe, step_bad = _sanitize(_chol(W))
        sigma_opt = symmetrize(_chol_solve(safe, eye_p.expand(safe.shape)))
        mu_opt = _mv(sigma_opt, w)

        A, B, c = matrices_from_vec(mu_opt, dx, du)
        P = _trace_blocks(sigma_opt.reshape(*lead, p1, dx, p1, dx), V)
        Pxx, Puu, Pxu = P[..., :dx, :dx], P[..., dx:dx + du, dx:dx + du], P[..., :dx, dx:dx + du]
        px, pu, p0 = P[..., :dx, -1], P[..., dx:dx + du, -1], P[..., -1, -1]

        A_cl = A + B @ K
        c_cl = c + _mv(B, kff)
        # σ_block is zero but for the control block (the intended util.cpp:771)
        sigma_block = torch.zeros(*lead, p1, p1, dtype=W.dtype, device=W.device)
        sigma_block[..., dx:dx + du, dx:dx + du] = sig_ctl
        kron_sb_V = _kron(sigma_block, V)
        mCuu, mCxu, mcu = -Cuu + Puu, -Cxu + Pxu, -cu + 2.0 * pu

        V_n = symmetrize((-Cxx + Pxx) + K.mT @ mCuu @ K + A_cl.mT @ V @ A_cl + 2.0 * mCxu @ K)
        Vc = _mv(V, c_cl)
        v_n = ((-cx + 2.0 * px) + 2.0 * _mv(K.mT @ mCuu, kff) + 2.0 * _mv(mCxu, kff)
               + _mv(K.mT, mcu) + 2.0 * _mv(A_cl.mT, Vc) + _mv(A_cl.mT, v))
        v0_n = ((-c0 + p0) + _dot(_mv(mCuu.mT, kff), kff) + _dot(kff, mcu)
                - _trace(Cuu_next @ sig_ctl) + v0 + _trace(V @ sigma_dyn[..., t, :, :])
                + _dot(_mv(kron_sb_V.mT, mu_opt), mu_opt) + _trace(kron_sb_V @ sigma_opt)
                + _dot(c_cl, Vc) + _dot(c_cl, v))
        V, v, v0 = V_n, v_n, v0_n
        bad = bad | step_bad
        mus.append(mu_opt)
        sigmas.append(sigma_opt)
        Vs.append(V)
        vs.append(v)
        v0s.append(v0)

    axis = len(lead)

    def stack(xs, last=None):
        xs = xs[::-1] + ([] if last is None else [last])
        return torch.stack(xs, axis)

    value = QuadraticValue(V=stack(Vs, -cost.Cxx[..., T, :, :]), v=stack(vs, -cost.cx[..., T, :]),
                           v0=stack(v0s, -cost.c0[..., T]))
    return MatrixNormalParams(mu=stack(mus), sigma=stack(sigmas)), value, bad
