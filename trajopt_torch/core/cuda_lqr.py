"""Batched regularized iLQR backward pass as one CUDA kernel (K4).

Counterpart of ``trajopt_tpu/core/pallas_lqr.py`` (``_ilqr_kernel``).  The
operands are structure-of-arrays streams with time leading, ``(T, entries,
Np)``: entry ``i·cols + j`` of each per-step block for all ``Np`` instances is
one contiguous row, so neighbouring threads (instances) read neighbouring
addresses.  ``Np`` is the batch padded to a multiple of 32; padding lanes
replicate instance 0 and their outputs are discarded.  The kernel copies the
streams a chunk of steps ahead into shared memory, where one consumer warp
per 16 instances walks the recursion (the staged backward of
``csrc/bwd_step.cuh``).

``cuda_ilqr_backward_packed`` launches ``csrc/ilqr_backward.cu`` on CUDA
tensors and runs the plain PyTorch version below on CPU tensors.  The plain
``bwd_step`` is shared with the fused kernel's plain version
(``cuda_fused``), as ``_bwd_step`` is shared in the JAX package.
"""

from __future__ import annotations

import ctypes

import torch
from torch import Tensor

from ..kernels import _build
from .types import QuadraticCost, symmetrize

LANE_MULTIPLE = 32


# --------------------------------------------------------------------------------------
# Layout: batch-leading ↔ structure of arrays (T, entries, Np)
# --------------------------------------------------------------------------------------


def lane_pad(N: int) -> int:
    """Instance count padded to a whole number of warps."""
    return max(LANE_MULTIPLE, -(-N // LANE_MULTIPLE) * LANE_MULTIPLE)


def to_soa(x: Tensor, n_pad: int) -> Tensor:
    """``(N, T, *dims)`` → contiguous ``(T, prod(dims), n_pad)``; padding lanes
    replicate instance 0."""
    N, T = x.shape[0], x.shape[1]
    x = x.reshape(N, T, -1)
    if n_pad > N:
        x = torch.cat([x, x[:1].expand(n_pad - N, *x.shape[1:])])
    return x.permute(1, 2, 0).contiguous()


def from_soa(x: Tensor, N: int, dims: tuple[int, ...]) -> Tensor:
    """``(T, prod(dims), Np)`` → ``(N, T, *dims)``."""
    T = x.shape[0]
    return x[..., :N].permute(2, 0, 1).reshape(N, T, *dims)


def check_lanes(what: str, Np: int) -> None:
    """The staged kernels (K1, K4) take whole groups of instances: ``Np`` must
    be a multiple of 32, as :func:`lane_pad` makes it."""
    if Np % LANE_MULTIPLE:
        raise ValueError(f"{what}: {Np} lanes; the kernel takes a multiple of "
                         f"{LANE_MULTIPLE} (pad the batch with lane_pad)")


def pad_lanes(x: Tensor, n_pad: int) -> Tensor:
    """Per-instance ``(N,)`` → ``(n_pad,)`` (λ, α, masks)."""
    return to_soa(x[:, None, None], n_pad)[0, 0]


def pack_lanes(cost: QuadraticCost, A: Tensor, B: Tensor, n_pad: int) -> dict:
    """Batch-leading cost ``(N, T+1, …)`` and dynamics ``(N, T, …)`` → the
    kernel's streams; ``vT``/``vvT`` are the terminal value (dx·dx, Np)/(dx, Np)."""
    T = A.shape[1]
    return dict(
        cxx=to_soa(cost.Cxx[:, :T], n_pad),
        cx=to_soa(cost.cx[:, :T], n_pad),
        cuu=to_soa(cost.Cuu[:, :T], n_pad),
        cu=to_soa(cost.cu[:, :T], n_pad),
        cxu=to_soa(cost.Cxu[:, :T], n_pad),
        A=to_soa(A, n_pad),
        B=to_soa(B, n_pad),
        vT=to_soa(cost.Cxx[:, T:], n_pad)[0],
        vvT=to_soa(cost.cx[:, T:], n_pad)[0],
    )


# --------------------------------------------------------------------------------------
# Plain PyTorch version
# --------------------------------------------------------------------------------------


def _mv(M: Tensor, x: Tensor) -> Tensor:
    return (M @ x.unsqueeze(-1)).squeeze(-1)


def _chol(S: Tensor):
    """Unrolled Cholesky–Banachiewicz of ``S (Np, n, n)`` per instance.  Lanes
    whose pivot is non-positive or non-finite are flagged and continue with a
    unit pivot so the arithmetic after them stays finite."""
    n = S.shape[-1]
    L = [[None] * n for _ in range(n)]
    inv_d = [None] * n
    bad = torch.zeros(S.shape[0], dtype=torch.bool, device=S.device)
    for j in range(n):
        s = S[:, j, j] - sum(L[j][k] * L[j][k] for k in range(j))
        good = (s > 0) & torch.isfinite(s)
        bad = bad | ~good
        L[j][j] = torch.sqrt(torch.where(good, s, torch.ones_like(s)))
        inv_d[j] = 1.0 / L[j][j]
        for i in range(j + 1, n):
            r = S[:, i, j] - sum(L[i][k] * L[j][k] for k in range(j))
            L[i][j] = r * inv_d[j]
    return L, inv_d, bad


def _chol_solve(L, inv_d, Bm: Tensor) -> Tensor:
    """Solve (L Lᵀ) X = B for ``B (Np, n, m)`` by forward and back substitution."""
    n = len(inv_d)
    cols = []
    for c in range(Bm.shape[-1]):
        b = Bm[:, :, c]
        y = [None] * n
        for i in range(n):
            y[i] = (b[:, i] - sum(L[i][k] * y[k] for k in range(i))) * inv_d[i]
        x = [None] * n
        for i in reversed(range(n)):
            x[i] = (y[i] - sum(L[k][i] * x[k] for k in range(i + 1, n))) * inv_d[i]
        cols.append(torch.stack(x, dim=-1))
    return torch.stack(cols, dim=-1)


def bwd_step(Cxx, cx, Cuu, cu, Cxu, A, B, V, v, dV, bad, lam, reg):
    """One regularized backward step for every instance at once (the body of
    ilqr/src/util.cpp:83-182); matrices ``(Np, r, c)``, vectors ``(Np, r)``,
    ``dV (Np, 2)``.  Returns (K, kff, V, v, dV, bad)."""
    VB = V @ B
    AT, BT = A.mT, B.mT
    Qxx = Cxx + AT @ (V @ A)
    Quu = Cuu + BT @ VB
    QuxT = Cxu + AT @ VB                  # = Quxᵀ, (dx, du)
    qx = cx + _mv(AT, v)
    qu = cu + _mv(BT, v)

    if reg == 1:
        QuxT_r = QuxT
        Quu_r = Quu + lam[:, None, None] * torch.eye(
            Quu.shape[-1], dtype=Quu.dtype, device=Quu.device
        )
    else:
        VB_r = VB + lam[:, None, None] * B
        QuxT_r = Cxu + AT @ VB_r
        Quu_r = Cuu + BT @ VB_r

    L, inv_d, step_bad = _chol(symmetrize(Quu_r))
    K = -_chol_solve(L, inv_d, QuxT_r.mT)
    kff = -_chol_solve(L, inv_d, qu.unsqueeze(-1)).squeeze(-1)

    Quu_kff = _mv(Quu, kff)
    dV = dV + torch.stack([(kff * qu).sum(-1), 0.5 * (kff * Quu_kff).sum(-1)], dim=-1)
    KT = K.mT
    v = qx + _mv(KT, Quu_kff) + _mv(KT, qu) + _mv(QuxT, kff)
    M = symmetrize(Qxx + KT @ (Quu @ K))
    P = KT @ QuxT.mT                      # Kᵀ Qux, (dx, dx)
    V = M + P + P.mT
    return K, kff, V, v, dV, bad | step_bad


def _ilqr_backward_plain(packed: dict, lam: Tensor, reg: int):
    T, _, Np = packed["A"].shape
    dx = packed["vvT"].shape[0]
    du = packed["cu"].shape[1]

    def block(name, t, r, c):
        return packed[name][t].reshape(r, c, Np).permute(2, 0, 1)

    V = packed["vT"].reshape(dx, dx, Np).permute(2, 0, 1)
    v = packed["vvT"].T
    dV = torch.zeros(Np, 2, dtype=V.dtype, device=V.device)
    bad = torch.zeros(Np, dtype=torch.bool, device=V.device)
    K_out = torch.empty(T, du * dx, Np, dtype=V.dtype, device=V.device)
    kff_out = torch.empty(T, du, Np, dtype=V.dtype, device=V.device)
    for t in reversed(range(T)):
        K, kff, V, v, dV, bad = bwd_step(
            block("cxx", t, dx, dx), packed["cx"][t].T,
            block("cuu", t, du, du), packed["cu"][t].T,
            block("cxu", t, dx, du), block("A", t, dx, dx), block("B", t, dx, du),
            V, v, dV, bad, lam, reg,
        )
        K_out[t] = K.reshape(Np, du * dx).T
        kff_out[t] = kff.T
    return K_out, kff_out, dV.T.contiguous(), bad


# --------------------------------------------------------------------------------------
# Kernel wrapper
# --------------------------------------------------------------------------------------

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_I, _I, _I] + [_P] * 14 + [_I, _I, _I, _P]


def cuda_ilqr_backward_packed(packed: dict, lam: Tensor, reg: int = 1):
    """Regularized iLQR backward on precomputed streams (K4).

    ``packed`` holds the streams of :func:`pack_lanes`; ``lam (Np,)`` is the
    per-instance λ.  Returns ``(K (T, du·dx, Np), kff (T, du, Np), dV (2, Np),
    bad (Np,) bool)``.  CUDA tensors launch the kernel (``Np`` a multiple of
    32, operands 16-byte aligned); CPU tensors run the plain version."""
    if reg not in (1, 2):
        raise ValueError(f"reg must be 1 or 2, got {reg}")
    names = ("cxx", "cx", "cuu", "cu", "cxu", "A", "B", "vT", "vvT")
    if packed["A"].device.type == "cpu":
        return _ilqr_backward_plain(packed, lam, reg)
    T, _, Np = packed["A"].shape
    dx = packed["vvT"].shape[0]
    du = packed["cu"].shape[1]
    check_lanes("K4 ilqr_backward", Np)
    ins = [packed[k] for k in names] + [lam]
    code = _build.cuda_operands("K4 ilqr_backward", *ins)
    if any(t.data_ptr() % 16 for t in ins):
        # the kernel stages the streams with 16-byte cp.async copies
        raise ValueError("K4 ilqr_backward: operands must be 16-byte aligned")
    dev, dt = lam.device, lam.dtype
    K = torch.empty(T, du * dx, Np, dtype=dt, device=dev)
    kff = torch.empty(T, du, Np, dtype=dt, device=dev)
    dV = torch.empty(2, Np, dtype=dt, device=dev)
    bad = torch.empty(Np, dtype=torch.bool, device=dev)
    fn = _build.function("ilqr_backward.cu", "trajopt_ilqr_backward", _ARGTYPES)
    with torch.cuda.device(dev):
        rc = fn(code, dx, du, *(t.data_ptr() for t in ins + [K, kff, dV, bad]),
                T, Np, reg, torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "K4 ilqr_backward")
    cuda_ilqr_backward_packed.launches += 1
    return K, kff, dV, bad


cuda_ilqr_backward_packed.launches = 0
