"""Parallel-in-time Riccati recursion (counterpart of the single-device part of
``trajopt_tpu/core/pscan_lqr.py``).

The LQR backward pass is an associative operation on conditional value
elements (Särkkä & García-Fernández): each step contributes

    V_e(x, z) = ½ (z − A x − b)ᵀ C⁻¹ (z − A x − b) + ½ xᵀ J x − ηᵀ x

and composing two elements (minimizing over the intermediate state) is closed
form in (A, b, C, η, J).  The suffix composites give every value function in
O(log T) depth.  PyTorch has no associative scan, so the suffix scan here runs
the doubling schedule that kernel K5 (``cuda_pscan``) runs: for d = 1, 2, 4, …
every position composes with the one d steps later, S_t ← S_t ⊗ S_{t+d}, and a
position whose partner lies past the terminal element takes the identity.

Elements compose in the ½-convention quadratic model
    cost_t(x, u) = ½xᵀQx + qᵀx + ½uᵀRu + rᵀu + xᵀMu,   z = F x + L u + c.
:func:`priccati_backward` maps the absolute convention onto it,
:func:`pilqr_backward` / :func:`pilqr_backward_lanes` the delta convention at
λ = 0, and :func:`pilqr_backward_reg` folds λ into the action Hessian (the
``backward="pscan"`` engine of ``parallel.mpc.make_ilqr_solver``).  Cholesky
failures give NaN (``utils.psd.cholesky``), so a non-PD action Hessian shows
up in the divergence flag of :func:`pilqr_backward_reg`.  The element, gain
and dV code takes the factorization as an argument: K5's plain version
(``cuda_pscan.pilqr_backward_plain``) passes the kernel's guarded one.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch import Tensor

from ..utils.psd import chol_solve, cholesky
from .types import LinearDynamics, LinearPolicy, QuadraticCost, QuadraticValue, symmetrize


class RiccatiElement(NamedTuple):
    A: Tensor    # (..., dx, dx)
    b: Tensor    # (..., dx)
    C: Tensor    # (..., dx, dx)
    eta: Tensor  # (..., dx)
    J: Tensor    # (..., dx, dx)


def _mv(M: Tensor, v: Tensor) -> Tensor:
    return (M @ v.unsqueeze(-1)).squeeze(-1)


def combine(e1: RiccatiElement, e2: RiccatiElement) -> RiccatiElement:
    """Compose two conditional value elements, batched over leading axes:
    (e1 ⊗ e2)(x, z) = min_y e1(x, y) + e2(y, z)."""
    dx = e1.A.shape[-1]
    eye = torch.eye(dx, dtype=e1.A.dtype, device=e1.A.device)

    # G = (I + C1 J2)⁻¹; (I + J2 C1)⁻¹ = Gᵀ for symmetric C, J
    G = torch.linalg.solve_ex(eye + e1.C @ e2.J, eye.expand(e1.C.shape))[0]
    Gt = G.mT

    A12 = e2.A @ G @ e1.A
    b12 = _mv(e2.A @ G, e1.b + _mv(e1.C, e2.eta)) + e2.b
    C12 = symmetrize(e2.A @ G @ e1.C @ e2.A.mT + e2.C)
    eta12 = _mv(e1.A.mT @ Gt, e2.eta - _mv(e2.J, e1.b)) + e1.eta
    J12 = symmetrize(e1.A.mT @ Gt @ e2.J @ e1.A + e1.J)
    return RiccatiElement(A=A12, b=b12, C=C12, eta=eta12, J=J12)


def make_elements(
    Q: Tensor, q: Tensor, R: Tensor, r: Tensor, M: Tensor,
    F: Tensor, L: Tensor, c: Tensor, Q_T: Tensor, q_T: Tensor, factor=cholesky,
) -> RiccatiElement:
    """Per-step elements of the ½-convention model plus the terminal element:
    stacked elements of length T+1, terminal last.  ``factor`` gives the lower
    Cholesky factor of R."""
    chol_R = factor(symmetrize(R))
    RiM = chol_solve(chol_R, M.mT)     # R⁻¹ Mᵀ
    Rir = chol_solve(chol_R, r)        # R⁻¹ r
    RiL = chol_solve(chol_R, L.mT)     # R⁻¹ Lᵀ
    els = RiccatiElement(
        A=F - L @ RiM,
        b=c - _mv(L, Rir),
        C=symmetrize(L @ RiL),
        eta=-(q - _mv(M, Rir)),
        J=symmetrize(Q - M @ RiM),
    )
    zero_m = torch.zeros_like(Q_T)[None]
    term = RiccatiElement(
        A=zero_m, b=torch.zeros_like(q_T)[None], C=zero_m, eta=-q_T[None], J=Q_T[None]
    )
    return RiccatiElement(*(torch.cat([a, t]) for a, t in zip(els, term)))


def _shift(x: Tensor, d: int, fill: Tensor, dim: int) -> Tensor:
    """Position t of ``x`` along ``dim`` takes position t + d; positions past
    the end take ``fill`` (broadcast along ``dim``)."""
    n = x.shape[dim]
    shape = list(x.shape)
    shape[dim] = min(d, n)
    tail = fill.unsqueeze(dim).expand(shape)
    return torch.cat([x.narrow(dim, min(d, n), n - min(d, n)), tail], dim=dim)


def _doubling_suffix(el, combine_fn, identity, dim: int):
    """Inclusive suffix composition el[t] ⊗ el[t+1] ⊗ … ⊗ el[n−1] for every t,
    in ⌈log₂ n⌉ levels of S_t ← S_t ⊗ S_{t+d}, d = 1, 2, 4, …"""
    n = el[0].shape[dim]
    d = 1
    while d < n:
        partner = type(el)(*(_shift(x, d, f, dim) for x, f in zip(el, identity)))
        el = combine_fn(el, partner)
        d *= 2
    return el


def _identity_element(dx: int, like: Tensor) -> RiccatiElement:
    """The neutral element of :func:`combine` (A = I, everything else 0)."""
    kw = dict(dtype=like.dtype, device=like.device)
    zm, zv = torch.zeros(dx, dx, **kw), torch.zeros(dx, **kw)
    return RiccatiElement(A=torch.eye(dx, **kw), b=zv, C=zm, eta=zv, J=zm)


def suffix_scan(elements: RiccatiElement) -> RiccatiElement:
    """result[t] = e_t ⊗ e_{t+1} ⊗ … ⊗ e_T for all t, in O(log T) depth."""
    ident = _identity_element(elements.A.shape[-1], elements.A)
    return _doubling_suffix(elements, combine, ident, dim=0)


def _gains(R, r, M, F, L, c, S_next, s_next, factor=cholesky):
    """Per-step feedback and feedforward from the next step's ½-model value,
    batched over time."""
    Quu = R + L.mT @ S_next @ L
    chol = factor(symmetrize(Quu))
    K = -chol_solve(chol, L.mT @ S_next @ F + M.mT)
    kff = -chol_solve(chol, _mv(L.mT, _mv(S_next, c) + s_next) + r)
    return K, kff


def _dv(kff, R, r, B, S_next, s_next) -> Tensor:
    """The dV pair Σ_t [kffᵀqu, ½ kffᵀ Quu kff] (ilqr/src/util.cpp:154)."""
    Quu = R + B.mT @ S_next @ B
    qu = r + _mv(B.mT, s_next)
    dv0 = (kff * qu).sum(-1)
    dv1 = (_mv(Quu.mT, 0.5 * kff) * kff).sum(-1)
    return torch.stack([dv0, dv1], dim=-1).sum(0)


def priccati_backward(
    cost: QuadraticCost, dyn: LinearDynamics
) -> tuple[LinearPolicy, QuadraticValue]:
    """Parallel-in-time Riccati backward pass in the absolute convention
    (Cxx = ½-scaled Hessians, value stored as xᵀVx + vᵀx)."""
    T = dyn.horizon
    Q, q = 2.0 * cost.Cxx[:T], cost.cx[:T]
    R, r = 2.0 * cost.Cuu[:T], cost.cu[:T]
    M = 2.0 * cost.Cxu[:T]
    Q_T, q_T = 2.0 * cost.Cxx[T], cost.cx[T]

    suf = suffix_scan(make_elements(Q, q, R, r, M, dyn.A, dyn.B, dyn.c, Q_T, q_T))
    # ½-model value: S_t = J_t, s_t = −η_t;  reference storage: V = S/2, v = s
    S, s = suf.J, -suf.eta
    K, kff = _gains(R, r, M, dyn.A, dyn.B, dyn.c, S[1:], s[1:])
    value = QuadraticValue(V=0.5 * S, v=s, v0=torch.zeros(T + 1, dtype=S.dtype, device=S.device))
    return LinearPolicy(K=K, kff=kff), value


def delta_backward(cost: QuadraticCost, A: Tensor, B: Tensor, suffix, factor=cholesky):
    """The delta-convention (λ = 0) backward pass on a given suffix scan and
    Cholesky factorization."""
    T = A.shape[0]
    c = torch.zeros(T, A.shape[-1], dtype=A.dtype, device=A.device)
    Q, q = cost.Cxx[:T], cost.cx[:T]
    R, r = cost.Cuu[:T], cost.cu[:T]
    M = cost.Cxu[:T]

    S, s = suffix(make_elements(Q, q, R, r, M, A, B, c, cost.Cxx[T], cost.cx[T], factor))
    K, kff = _gains(R, r, M, A, B, c, S[1:], s[1:], factor)
    dV = _dv(kff, R, r, B, S[1:], s[1:])
    value = QuadraticValue(V=S, v=s, v0=torch.zeros(T + 1, dtype=S.dtype, device=S.device))
    return LinearPolicy(K=K, kff=kff), value, dV


def pilqr_backward(
    cost: QuadraticCost, A: Tensor, B: Tensor
) -> tuple[LinearPolicy, QuadraticValue, Tensor]:
    """Parallel-in-time unregularized iLQR backward pass (ilqr/src/util.cpp:83-182
    at λ = 0); also returns the dV improvement pair."""
    def suffix(els):
        suf = suffix_scan(els)
        return suf.J, -suf.eta

    return delta_backward(cost, A, B, suffix)


# --------------------------------------------------------------------------------------
# Lane-major parallel Riccati
# --------------------------------------------------------------------------------------
#
# Each matrix entry is its own plane over time, and the combine is unrolled
# scalar arithmetic on planes.  The (I + C₁J₂)⁻¹ solve is a Gauss–Jordan
# elimination with per-entry partial pivoting: the eigenvalues (all ≥ 1) of
# I + C₁J₂ do not keep its leading principal minors away from zero, so a
# pivot-free elimination fails on valid PSD inputs.  Kernel K5 runs the same
# arithmetic (``csrc/pscan_backward.cu``).


class LaneElement(NamedTuple):
    A: Tensor    # (dx*dx, T)
    b: Tensor    # (dx, T)
    C: Tensor    # (dx*dx, T)
    eta: Tensor  # (dx, T)
    J: Tensor    # (dx*dx, T)


def _to_planes(M: Tensor) -> Tensor:
    """(T, n, m) → (n*m, T) entry-major planes."""
    return M.reshape(M.shape[0], -1).T


def _rows(P, n: int, m: int):
    return [[P[i * m + j] for j in range(m)] for i in range(n)]


def _lmm(A, B):
    n, k, m = len(A), len(B), len(B[0])
    return [[sum(A[i][l] * B[l][j] for l in range(k)) for j in range(m)]
            for i in range(n)]


def _lmv(A, x):
    return [sum(A[i][j] * x[j] for j in range(len(x))) for i in range(len(A))]


def _lt(A):
    return [[A[i][j] for i in range(len(A))] for j in range(len(A[0]))]


def _gj_inv(A):
    """Gauss–Jordan inverse with partial pivoting of a small matrix given as
    rows of planes: each step compare-swaps the pivot row against every later
    row per entry (a running maximum, so partial pivoting)."""
    n = len(A)
    M = [row[:] for row in A]
    one = torch.ones_like(A[0][0])
    zero = torch.zeros_like(A[0][0])
    I = [[one if i == j else zero for j in range(n)] for i in range(n)]
    for k in range(n):
        for i in range(k + 1, n):
            swap = M[i][k].abs() > M[k][k].abs()
            for j in range(n):
                mk, mi = M[k][j], M[i][j]
                M[k][j] = torch.where(swap, mi, mk)
                M[i][j] = torch.where(swap, mk, mi)
                ik, ii = I[k][j], I[i][j]
                I[k][j] = torch.where(swap, ii, ik)
                I[i][j] = torch.where(swap, ik, ii)
        piv = 1.0 / M[k][k]
        M[k] = [e * piv for e in M[k]]
        I[k] = [e * piv for e in I[k]]
        for i in range(n):
            if i == k:
                continue
            f = M[i][k]
            M[i] = [M[i][j] - f * M[k][j] for j in range(n)]
            I[i] = [I[i][j] - f * I[k][j] for j in range(n)]
    return I


def combine_lists(e1, e2, dx: int):
    """The composition of :func:`combine` on elements given as lists of planes
    ``(A rows, b, C rows, η, J rows)``; ``e1`` is the earlier element."""
    A1, b1, C1, n1, J1 = e1
    A2, b2, C2, n2, J2 = e2

    C1J2 = _lmm(C1, J2)
    M = [[C1J2[i][j] + (1.0 if i == j else 0.0) for j in range(dx)]
         for i in range(dx)]
    G = _gj_inv(M)                      # (I + C1 J2)⁻¹
    Gt = _lt(G)

    A2G = _lmm(A2, G)
    A12 = _lmm(A2G, A1)
    b12 = [s + b2[i] for i, s in enumerate(_lmv(A2G, [
        b1[k] + sum(C1[k][l] * n2[l] for l in range(dx)) for k in range(dx)
    ]))]
    C12 = _lmm(_lmm(A2G, C1), _lt(A2))
    C12 = [[0.5 * (C12[i][j] + C12[j][i]) + C2[i][j] for j in range(dx)]
           for i in range(dx)]
    A1tGt = _lmm(_lt(A1), Gt)
    n12 = [s + n1[i] for i, s in enumerate(_lmv(A1tGt, [
        n2[k] - sum(J2[k][l] * b1[l] for l in range(dx)) for k in range(dx)
    ]))]
    J12 = _lmm(_lmm(A1tGt, J2), A1)
    J12 = [[0.5 * (J12[i][j] + J12[j][i]) + J1[i][j] for j in range(dx)]
           for i in range(dx)]
    return (A12, b12, C12, n12, J12)


def _combine_lanes(e1: LaneElement, e2: LaneElement, dx: int) -> LaneElement:
    """:func:`combine_lists` on stacked entry planes."""
    def split(e):
        return (_rows(e.A, dx, dx), list(e.b), _rows(e.C, dx, dx), list(e.eta),
                _rows(e.J, dx, dx))

    A, b, C, eta, J = combine_lists(split(e1), split(e2), dx)
    stack = lambda rows: torch.stack([e for row in rows for e in row])  # noqa: E731
    return LaneElement(A=stack(A), b=torch.stack(b), C=stack(C), eta=torch.stack(eta),
                       J=stack(J))


def suffix_scan_lanes(elements: RiccatiElement) -> tuple[Tensor, Tensor]:
    """Lane-major suffix scan: (S (T+1, dx, dx), s (T+1, dx)), the J planes and
    the negated η planes of the suffix composites, the only parts the gains
    consume."""
    dx = elements.A.shape[-1]
    els = LaneElement(
        A=_to_planes(elements.A), b=elements.b.T, C=_to_planes(elements.C),
        eta=elements.eta.T, J=_to_planes(elements.J),
    )
    ident = _identity_element(dx, elements.A)
    ident = LaneElement(A=ident.A.reshape(-1), b=ident.b, C=ident.C.reshape(-1),
                        eta=ident.eta, J=ident.J.reshape(-1))
    suf = _doubling_suffix(els, lambda x, y: _combine_lanes(x, y, dx), ident, dim=1)
    S = suf.J.T.reshape(-1, dx, dx)
    s = -suf.eta.T
    return S, s


def pilqr_backward_lanes(
    cost: QuadraticCost, A: Tensor, B: Tensor
) -> tuple[LinearPolicy, QuadraticValue, Tensor]:
    """Lane-major counterpart of :func:`pilqr_backward` (same contract)."""
    return delta_backward(cost, A, B, suffix_scan_lanes)


def pilqr_backward_reg(
    cost: QuadraticCost, A: Tensor, B: Tensor, lmbda: Tensor | float = 0.0
) -> tuple[LinearPolicy, QuadraticValue, Tensor, Tensor]:
    """Lane-major parallel iLQR backward with λ folded into the action Hessian
    (``Cuu + λI``: exact at λ = 0, a proximal variant above) and a NaN/Inf
    divergence flag on K, kff and V: the ``backward="pscan"`` solver engine."""
    du = B.shape[-1]
    lam_eye = lmbda * torch.eye(du, dtype=A.dtype, device=A.device)
    ctl, value, dV = pilqr_backward_lanes(cost._replace(Cuu=cost.Cuu + lam_eye), A, B)
    diverged = ~(
        torch.isfinite(ctl.K).all()
        & torch.isfinite(ctl.kff).all()
        & torch.isfinite(value.V).all()
    )
    return ctl, value, dV, diverged
