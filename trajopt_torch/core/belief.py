"""Belief-space LQR pieces of BSP-iLQR (counterpart of
``trajopt_tpu/core/belief.py``): the expansions of the belief dynamics and
the belief cost, and the dense (S, s, τ) value backward.

The belief value is quadratic in the belief mean with a linear channel τ
against vec(Σ): V(b) = ½ μᵀSμ + sᵀμ + τᵀvec(Σ).  The belief dynamics map
(μ, Σ, u) ↦ (f, W, Φ), one EKF predict and gain step, is differentiated as a
whole with ``torch.func.jacfwd``.  It holds the Jacobians of the env's
dynamics and observation model, so its Jacobian is a second derivative
(nested forward mode).

vec order: every vectorized matrix (Σ, S, W, Φ) is symmetric, so C order is
used throughout, as in the JAX package.

The τ-index fix: bspilqr/src/util.cpp:158 contracts ``U`` against
``tau.col(i)``, memory not yet written at that point of the backward loop;
the van den Berg recursion calls for the next step's τ, τ_{t+1}, which is
used here as in the JAX package.

All functions take any leading batch axes in front of the time axis.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch import Tensor
from torch.func import grad, hessian, jacfwd, jacrev, vmap

from ..envs.base import _matvec
from ..utils.psd import chol_solve, cholesky
from .ekf import belief_ekf_step
from .types import LinearPolicy, symmetrize


class BeliefDynamicsExpansion(NamedTuple):
    """First-order expansion blocks of the belief-dynamics map, stacked over
    time: rows of the Jacobian of (f, vec W, vec Φ) with respect to
    (μ, vec Σ, u), sliced as in bspilqr/objects.py:247-256."""

    F: Tensor  # (T, b, b)      df/dmu
    G: Tensor  # (T, b, a)      df/du
    X: Tensor  # (T, b*b, b)    dW/dmu
    Y: Tensor  # (T, b*b, b*b)  dW/dvec(Sigma)
    Z: Tensor  # (T, b*b, a)    dW/du
    T: Tensor  # (T, b*b, b)    dPhi/dmu
    U: Tensor  # (T, b*b, b*b)  dPhi/dvec(Sigma)
    V: Tensor  # (T, b*b, a)    dPhi/du


class BeliefCostExpansion(NamedTuple):
    """Raw quadratic expansion of the belief cost about the reference
    (bspilqr/objects.py:111-144)."""

    Q: Tensor  # (T+1, b, b)   Hessian in mu
    q: Tensor  # (T+1, b)      gradient in mu
    R: Tensor  # (T+1, a, a)   Hessian in u
    r: Tensor  # (T+1, a)      gradient in u
    P: Tensor  # (T+1, b, a)   mixed mu/u
    p: Tensor  # (T+1, b*b)    gradient in vec(Sigma)


def belief_dynamics_expansion(env, mu_b: Tensor, sigma_b: Tensor, us: Tensor
                              ) -> BeliefDynamicsExpansion:
    """Jacobian of the flattened EKF belief map along a belief trajectory:
    ``mu_b (..., T, b)``, ``sigma_b (..., T, b, b)``, ``us (..., T, a)``."""
    b, a = mu_b.shape[-1], us.shape[-1]
    bb = b * b

    def flat_dyn(z):
        f, W, phi = belief_ekf_step(env, z[:b], z[b:b + bb].reshape(b, b), z[b + bb:])
        return torch.cat([f, W.reshape(-1), phi.reshape(-1)])

    lead = mu_b.shape[:-1]
    z = torch.cat([mu_b, sigma_b.reshape(*lead, bb), us], dim=-1).reshape(-1, b + bb + a)
    J = vmap(jacfwd(flat_dyn))(z).reshape(*lead, b + 2 * bb, b + bb + a)
    rows_f, rows_w, rows_p = J[..., :b, :], J[..., b:b + bb, :], J[..., b + bb:, :]
    return BeliefDynamicsExpansion(
        F=rows_f[..., :b], G=rows_f[..., b + bb:],
        X=rows_w[..., :b], Y=rows_w[..., b:b + bb], Z=rows_w[..., b + bb:],
        T=rows_p[..., :b], U=rows_p[..., b:b + bb], V=rows_p[..., b + bb:],
    )


def belief_cost_expansion(env, mu_b: Tensor, sigma_b: Tensor, us: Tensor
                          ) -> BeliefCostExpansion:
    """Raw second-order expansion of ``env.cost(μ, Σ, u)`` along the belief
    trajectory, T+1 slices with the terminal action zero-padded
    (bspilqr/objects.py:129-144).  ``mu_b (..., T+1, b)``,
    ``sigma_b (..., T+1, b, b)``, ``us (..., T, a)``."""
    b, a = mu_b.shape[-1], us.shape[-1]
    u_pad = torch.cat([us, torch.zeros_like(us[..., :1, :])], dim=-2)
    cost = env.cost

    def expand(mu, sig, u):
        return (hessian(cost, argnums=0)(mu, sig, u), grad(cost, argnums=0)(mu, sig, u),
                hessian(cost, argnums=2)(mu, sig, u), grad(cost, argnums=2)(mu, sig, u),
                jacfwd(jacrev(cost, argnums=0), argnums=2)(mu, sig, u),
                grad(cost, argnums=1)(mu, sig, u).reshape(-1))

    lead = mu_b.shape[:-1]
    outs = vmap(expand)(mu_b.reshape(-1, b), sigma_b.reshape(-1, b, b), u_pad.reshape(-1, a))
    return BeliefCostExpansion(*(o.reshape(*lead, *o.shape[1:]) for o in outs))


def bsp_backward(cost: BeliefCostExpansion, dyn: BeliefDynamicsExpansion, lmbda: Tensor,
                 reg: int):
    """The belief-value backward recursion with the vec(Σ) channel
    (bspilqr/src/util.cpp:83-204, with the τ-index fix).

    ``cost`` stacks ``(..., T+1, …)``, ``dyn`` ``(..., T, …)``, ``lmbda (...)``
    one λ per problem.  A step whose regularized action Hessian has no
    Cholesky factor (``jnp.linalg.cholesky``'s NaN) sets the flag and
    continues with the identity factor.  Returns (policy, S (..., T+1, b, b),
    s (..., T+1, b), τ (..., T+1, b²), dS (..., 2), diverged (...))."""
    if reg not in (1, 2):
        raise ValueError(f"reg must be 1 or 2, got {reg}")
    Tn = dyn.F.shape[-3]
    b, a = dyn.F.shape[-1], dyn.G.shape[-1]
    kw = dict(dtype=dyn.F.dtype, device=dyn.F.device)
    eye_b, eye_a = torch.eye(b, **kw), torch.eye(a, **kw)
    lam = lmbda[..., None, None]

    S_n, s_n, tau_n = cost.Q[..., Tn, :, :], cost.q[..., Tn, :], cost.p[..., Tn, :]
    dS = torch.zeros(*lmbda.shape, 2, **kw)
    bad = torch.zeros(lmbda.shape, dtype=torch.bool, device=lmbda.device)
    Ks, kffs, Ss, ss, taus = [], [], [], [], []
    for t in reversed(range(Tn)):
        Q, q, R, r = (cost.Q[..., t, :, :], cost.q[..., t, :], cost.R[..., t, :, :],
                      cost.r[..., t, :])
        P, p = cost.P[..., t, :, :], cost.p[..., t, :]
        F, G, X, Y, Z, T_, U, V = (m[..., t, :, :] for m in dyn)
        FT, GT = F.mT, G.mT

        C = Q + FT @ S_n @ F
        D = R + GT @ S_n @ G
        E = (P + FT @ S_n @ G).mT

        vecS = S_n.reshape(*S_n.shape[:-2], b * b)
        c = q + _matvec(FT, s_n) + _matvec(T_.mT, tau_n) + 0.5 * _matvec(X.mT, vecS)
        d = r + _matvec(GT, s_n) + _matvec(V.mT, tau_n) + 0.5 * _matvec(Z.mT, vecS)
        e = p + _matvec(U.mT, tau_n) + 0.5 * _matvec(Y.mT, vecS)

        S_reg = S_n + (lam * eye_b if reg == 2 else 0.0 * eye_b)
        E_reg = (P + FT @ S_reg @ G).mT
        D_reg = R + GT @ S_reg @ G + (lam * eye_a if reg == 1 else 0.0 * eye_a)

        chol = cholesky(symmetrize(D_reg))
        finite = torch.isfinite(chol)
        bad = bad | ~finite.all(-1).all(-1)
        safe = torch.where(finite, chol, eye_a)
        K = -chol_solve(safe, E_reg)
        kff = -chol_solve(safe, d)

        dS = dS + torch.stack([(kff * d).sum(-1), 0.5 * (kff * _matvec(D, kff)).sum(-1)],
                              dim=-1)
        tau_n = e
        s_n = c + _matvec(K.mT @ D, kff) + _matvec(K.mT, d) + _matvec(E.mT, kff)
        S_n = symmetrize(C + K.mT @ D @ K + K.mT @ E + E.mT @ K)
        Ks.append(K)
        kffs.append(kff)
        Ss.append(S_n)
        ss.append(s_n)
        taus.append(tau_n)

    axis = lmbda.dim()

    def stack(xs, last):
        return torch.stack(xs[::-1] + [last], dim=axis)

    policy = LinearPolicy(K=torch.stack(Ks[::-1], dim=axis), kff=torch.stack(kffs[::-1], dim=axis))
    return (policy, stack(Ss, cost.Q[..., Tn, :, :]), stack(ss, cost.q[..., Tn, :]),
            stack(taus, cost.p[..., Tn, :]), dS, bad)
