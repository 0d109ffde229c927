"""Single-problem parallel-in-time iLQR backward pass as one CUDA kernel (K5).

Counterpart of ``trajopt_tpu/core/pallas_pscan.py`` (``_pscan_kernel``):
:func:`cuda_pilqr_backward` and :func:`cuda_pilqr_backward_reg` keep the
contracts of ``pallas_pilqr_backward`` and ``pallas_pilqr_backward_reg``.  CUDA
tensors launch ``csrc/pscan_backward.cu``; CPU tensors run
:func:`pilqr_backward_plain`, the lane-major pass of ``core.pscan_lqr`` with
the kernel's Cholesky guard.

The kernel keeps the TPU kernel's own Cholesky guard: a pivot that is not
positive or not finite becomes 1.  So a non-PD R or Quu gives finite gains and
no divergence flag here, where the ``pscan`` engine (``core.pscan_lqr``, on
``jnp.linalg.cholesky``'s NaN contract) flags it: each engine keeps its JAX
counterpart's semantics.
"""

from __future__ import annotations

import ctypes

import torch
from torch import Tensor

from ..kernels import _build
from .cuda_lqr import _chol
from .pscan_lqr import delta_backward, suffix_scan_lanes
from .types import LinearPolicy, QuadraticCost, QuadraticValue

# --------------------------------------------------------------------------------------
# Plain PyTorch version
# --------------------------------------------------------------------------------------


def _guarded_cholesky(S: Tensor) -> Tensor:
    """Lower Cholesky factor of each matrix of ``S (..., n, n)`` with the
    kernel's guard (``cuda_lqr._chol``): a pivot that is not positive or not
    finite becomes 1, so the factor stays finite."""
    n = S.shape[-1]
    L, _, _ = _chol(S.reshape(-1, n, n))
    zero = torch.zeros_like(L[0][0])
    rows = [torch.stack([L[i][j] if j <= i else zero for j in range(n)], dim=-1)
            for i in range(n)]
    return torch.stack(rows, dim=-2).reshape(S.shape)


def pilqr_backward_plain(
    cost: QuadraticCost, A: Tensor, B: Tensor
) -> tuple[LinearPolicy, QuadraticValue, Tensor]:
    """K5's plain version: the lane-major pass of ``core.pscan_lqr`` (partial
    pivoting Gauss–Jordan combine, K5's doubling schedule) with the kernel's
    Cholesky guard in place of the NaN contract."""
    return delta_backward(cost, A, B, suffix_scan_lanes, factor=_guarded_cholesky)


# --------------------------------------------------------------------------------------
# Kernel wrappers
# --------------------------------------------------------------------------------------

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_I, _I, _I] + [_P] * 13 + [_I, _P]


def cuda_pilqr_backward(
    cost: QuadraticCost, A: Tensor, B: Tensor
) -> tuple[LinearPolicy, QuadraticValue, Tensor]:
    """Single-problem parallel-in-time iLQR backward pass (λ = 0) as one
    launch of K5: the contract of ``core.pscan_lqr.pilqr_backward``.

    ``cost`` stacks have T+1 steps (slice T is the terminal cost; the kernel
    reads steps t < T of Cuu, cu and Cxu), ``A (T, dx, dx)``, ``B (T, dx, du)``.
    CUDA tensors launch the kernel; CPU tensors run the plain version."""
    if A.device.type == "cpu":
        return pilqr_backward_plain(cost, A, B)
    T, dx, du = A.shape[0], A.shape[-1], B.shape[-1]
    if T < 1:
        raise ValueError("K5 pscan_backward: the horizon must be at least 1")
    ins = [cost.Cxx, cost.cx, cost.Cuu, cost.cu, cost.Cxu, A, B]
    if cost.Cxx.shape[0] < T + 1 or cost.cx.shape[0] < T + 1 or min(
        x.shape[0] for x in ins[2:5]
    ) < T:
        raise ValueError("K5 pscan_backward: the cost stacks are shorter than the horizon")
    ins = [x.contiguous() for x in ins]
    code = _build.cuda_operands("K5 pscan_backward", *ins)
    kw = dict(dtype=A.dtype, device=A.device)
    K = torch.empty(T, du, dx, **kw)
    kff = torch.empty(T, du, **kw)
    S = torch.empty(T + 1, dx, dx, **kw)
    s = torch.empty(T + 1, dx, **kw)
    dV = torch.empty(2, **kw)
    scratch = torch.empty(2 * (3 * dx * dx + 2 * dx) * (T + 1), **kw)
    fn = _build.function("pscan_backward.cu", "trajopt_pscan_backward", _ARGTYPES)
    with torch.cuda.device(A.device):
        rc = fn(code, dx, du, *(t.data_ptr() for t in ins + [K, kff, S, s, dV, scratch]),
                T, torch.cuda.current_stream(A.device).cuda_stream)
    _build.check(rc, "K5 pscan_backward")
    cuda_pilqr_backward.launches += 1
    value = QuadraticValue(V=S, v=s, v0=torch.zeros(T + 1, **kw))
    return LinearPolicy(K=K, kff=kff), value, dV


cuda_pilqr_backward.launches = 0


def cuda_pilqr_backward_reg(
    cost: QuadraticCost, A: Tensor, B: Tensor, lmbda: Tensor | float = 0.0
) -> tuple[LinearPolicy, QuadraticValue, Tensor, Tensor]:
    """λ folded into the action Hessian before the kernel (``Cuu + λI``), plus
    a NaN/Inf divergence flag on K, kff and V: the ``backward="cuda-pscan"``
    engine of ``parallel.mpc.make_ilqr_solver``."""
    du = B.shape[-1]
    lam_eye = lmbda * torch.eye(du, dtype=A.dtype, device=A.device)
    ctl, value, dV = cuda_pilqr_backward(cost._replace(Cuu=cost.Cuu + lam_eye), A, B)
    diverged = ~(
        torch.isfinite(ctl.K).all()
        & torch.isfinite(ctl.kff).all()
        & torch.isfinite(value.V).all()
    )
    return ctl, value, dV, diverged
