"""The batched belief-value backward as one CUDA kernel, K8 (``csrc/belief.cu``).

Counterpart of ``trajopt_tpu/core/pallas_belief.py``.  One launch runs the
(S, s, τ) recursion of BSP-iLQR for a whole batch of problems, each with its
own λ, with the reg ∈ {1, 2} semantics of the scan recursion
(``core/belief.bsp_backward``) and the τ-index fix.  Its Cholesky guard is
the TPU kernel's (``cuda_lqr._chol``): a pivot that is not positive or not
finite becomes 1, so a non-PD step gives finite outputs and sets the flag,
where the scan recursion flags it and continues with the identity factor.

Operands are structure-of-arrays streams with time leading, ``(T, entries,
N)`` (entry ``i·cols + j`` of each per-step block for all N instances is one
contiguous row; no padding).  :func:`pack_belief` writes them once per
outer iteration; a λ-escalation trial passes only its λ vector ``(N,)``.
:func:`cuda_bsp_backward` takes and returns batch-leading containers, with
the contract of ``pallas_bsp_backward``.  CUDA tensors launch the kernel;
CPU tensors run :func:`bsp_backward_plain`, which does the kernel's
arithmetic step by step, batched over N, every sum in the kernel's order.
"""

from __future__ import annotations

import ctypes

import torch
from torch import Tensor

from ..kernels import _build
from .belief import BeliefCostExpansion, BeliefDynamicsExpansion
from .cuda_gps import _dot, _mm, _mm_tn, _mv, _mv_tn
from .cuda_lqr import _chol, _chol_solve, from_soa, to_soa
from .types import LinearPolicy, symmetrize

_STEP_KEYS = ("Q", "q", "R", "r", "P", "p", "F", "G", "X", "Y", "Z", "T", "U", "V")


def pack_belief(cost: BeliefCostExpansion, dyn: BeliefDynamicsExpansion) -> dict:
    """The operands of a backward pass but λ, in the kernel's layout, once per
    expansion.  Batch-leading inputs: ``cost`` stacks ``(N, T+1, …)`` (slice
    T the terminal value), ``dyn`` ``(N, T, …)``."""
    N, T = dyn.F.shape[:2]
    steps = {k: to_soa(getattr(cost, k)[:, :T], N) for k in ("Q", "q", "R", "r", "P", "p")}
    steps.update({k: to_soa(getattr(dyn, k), N) for k in dyn._fields})
    return dict(steps, QT=to_soa(cost.Q[:, T:], N)[0], qT=to_soa(cost.q[:, T:], N)[0],
                pT=to_soa(cost.p[:, T:], N)[0])


def _dims(packed: dict) -> tuple[int, int, int, int]:
    T, b, N = packed["q"].shape
    return T, b, packed["r"].shape[1], N


def bsp_backward_plain(packed: dict, lam: Tensor, reg: int):
    """K8's plain version, with the outputs of :func:`cuda_bsp_backward_packed`
    (pallas_belief.py:54-151)."""
    T, b, a, N = _dims(packed)
    bb = b * b
    shapes = dict(Q=(b, b), R=(a, a), P=(b, a), F=(b, b), G=(b, a), X=(bb, b), Y=(bb, bb),
                  Z=(bb, a), T=(bb, b), U=(bb, bb), V=(bb, a))
    S = packed["QT"].reshape(b, b, N).permute(2, 0, 1)
    sv, tau = packed["qT"].T, packed["pT"].T
    kw = dict(dtype=S.dtype, device=S.device)
    ds0 = ds1 = torch.zeros(N, **kw)
    bad = torch.zeros(N, dtype=torch.bool, device=S.device)
    outs = [torch.empty(T, n, N, **kw) for n in (a * b, a, bb, b, bb)]
    lam3 = lam[:, None, None]
    for t in reversed(range(T)):
        blk = {k: (packed[k][t].reshape(*shapes[k], N).permute(2, 0, 1) if k in shapes
                   else packed[k][t].T) for k in _STEP_KEYS}
        Q, q, R, r, P, p = (blk[k] for k in ("Q", "q", "R", "r", "P", "p"))
        F, G, X, Y, Z, Tm, U, V = (blk[k] for k in ("F", "G", "X", "Y", "Z", "T", "U", "V"))
        SF, SG = _mm(S, F), _mm(S, G)
        C = Q + _mm_tn(F, SF)
        D = R + _mm_tn(G, SG)
        E = (P + _mm_tn(F, SG)).mT
        vecS = S.reshape(N, bb)
        c = q + _mv_tn(F, sv) + _mv_tn(Tm, tau) + 0.5 * _mv_tn(X, vecS)
        d = r + _mv_tn(G, sv) + _mv_tn(V, tau) + 0.5 * _mv_tn(Z, vecS)
        e = p + _mv_tn(U, tau) + 0.5 * _mv_tn(Y, vecS)
        if reg == 2:
            SG_r = SG + lam3 * G
            D_reg = R + _mm_tn(G, SG_r)
            E_reg = (P + _mm_tn(F, SG_r)).mT
        else:
            D_reg = D + torch.diag_embed(lam[:, None].expand(N, a))
            E_reg = E
        L, inv_d, step_bad = _chol(symmetrize(D_reg))
        bad = bad | step_bad
        K = -_chol_solve(L, inv_d, E_reg)
        kff = -_chol_solve(L, inv_d, d[..., None])[..., 0]
        D_kff = _mv(D, kff)
        ds0 = ds0 + _dot(kff, d)
        ds1 = ds1 + 0.5 * _dot(kff, D_kff)
        tau = e
        sv = c + _mv_tn(K, D_kff) + _mv_tn(K, d) + _mv_tn(E, kff)
        KE = _mm_tn(K, E)
        S = symmetrize(C + _mm_tn(K, _mm(D, K)) + KE + KE.mT)
        for out, x in zip(outs, (K, kff, S, sv, tau)):
            out[t] = x.reshape(N, -1).T
    return (*outs, torch.stack([ds0, ds1]), bad)


_P, _I = ctypes.c_void_p, ctypes.c_int


def cuda_bsp_backward_packed(packed: dict, lam: Tensor, reg: int = 1):
    """K8 on the streams of :func:`pack_belief` and λ ``(N,)``.

    Returns ``(K (T, a·b, N), kff (T, a, N), S (T, b·b, N), s (T, b, N),
    τ (T, b², N), dS (2, N), diverged (N,) bool)``, the values of steps
    0 … T−1 (the terminal value is the cost's).  CUDA tensors launch the
    kernel; CPU tensors run :func:`bsp_backward_plain`."""
    if reg not in (1, 2):
        raise ValueError(f"reg must be 1 or 2, got {reg}")
    if packed["F"].device.type == "cpu":
        return bsp_backward_plain(packed, lam, reg)
    T, b, a, N = _dims(packed)
    ins = [packed[k] for k in _STEP_KEYS] + [packed["QT"], packed["qT"], packed["pT"], lam]
    code = _build.cuda_operands("K8 bsp_backward", *ins)
    kw = dict(dtype=lam.dtype, device=lam.device)
    outs = [torch.empty(T, n, N, **kw) for n in (a * b, a, b * b, b, b * b)]
    outs += [torch.empty(2, N, **kw), torch.empty(N, dtype=torch.bool, device=lam.device)]
    fn = _build.function("belief.cu", "trajopt_bsp_backward", [_I] * 3 + [_P] * 25 + [_I] * 3 + [_P])
    with torch.cuda.device(lam.device):
        rc = fn(code, b, a, *(t.data_ptr() for t in ins + outs), T, N, reg,
                torch.cuda.current_stream(lam.device).cuda_stream)
    _build.check(rc, "K8 bsp_backward")
    cuda_bsp_backward_packed.launches += 1
    return tuple(outs)


cuda_bsp_backward_packed.launches = 0


def unpack_belief(outs, cost: BeliefCostExpansion):
    """K8's outputs → ``pallas_bsp_backward``'s contract, batch-leading, the
    terminal slices of S, s and τ taken from ``cost``."""
    K_l, kff_l, S_l, s_l, tau_l, dS_l, bad = outs
    N, T = K_l.shape[2], K_l.shape[0]
    b, a = s_l.shape[1], kff_l.shape[1]
    policy = LinearPolicy(K=from_soa(K_l, N, (a, b)), kff=from_soa(kff_l, N, (a,)))

    def full(x, dims, last):
        return torch.cat([from_soa(x, N, dims), last[:, None]], dim=1)

    return (policy, full(S_l, (b, b), cost.Q[:, T]), full(s_l, (b,), cost.q[:, T]),
            full(tau_l, (b * b,), cost.p[:, T]), dS_l.T, bad)


def cuda_bsp_backward(cost: BeliefCostExpansion, dyn: BeliefDynamicsExpansion, lmbda: Tensor,
                      reg: int = 1):
    """K8 on batch-leading operands, with the contract of
    ``pallas_bsp_backward`` (and of ``bsp_backward`` over a batch): ``cost``
    ``(N, T+1, …)``, ``dyn`` ``(N, T, …)``, ``lmbda (N,)``.  Returns (policy,
    S (N, T+1, b, b), s (N, T+1, b), τ (N, T+1, b²), dS (N, 2), diverged
    (N,))."""
    return unpack_belief(cuda_bsp_backward_packed(pack_belief(cost, dyn), lmbda.contiguous(),
                                                  reg), cost)
