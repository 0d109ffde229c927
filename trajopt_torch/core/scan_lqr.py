"""Sequential iLQR backward pass (counterpart of ``trajopt_tpu/core/scan_lqr.py``).

A Python loop over time with batched small matrix products; any leading batch
dimensions run together.  The hot-path engines are the CUDA kernels in
``cuda_lqr``/``cuda_fused``; this is the ``backward="scan"`` reference.
"""

from __future__ import annotations

import torch
from torch import Tensor

from ..utils.psd import cholesky
from .types import LinearPolicy, QuadraticCost, QuadraticQValue, QuadraticValue, symmetrize


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
