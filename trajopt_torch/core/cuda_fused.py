"""Fused linearize → quadratize → backward iLQR as one CUDA kernel (K1).

Counterpart of ``trajopt_tpu/core/pallas_fused.py`` (``_fused_kernel``).  From
the reference trajectory streams alone — ``xref``/``uref``/``u_last`` ``(T,
·, Np)`` and the terminal state ``xT (dx, Np)`` — the kernel computes, per
instance and step,

* A, B as the tangents of the env's RK4 step (``tile_dynamics``: action clip,
  RK4, state clip, with JAX's tie rule at the bounds) through a forward-mode
  dual number carrying dx + du tangents;
* the closed-form delta-convention cost quadratization of the base
  feature-goal cost: ``Cxx = 2w·JᵀGJ``, ``cx = 2w·JᵀG(z₀−g)``, ``Cuu =
  2·diag(uw)``, ``cu = 2·uw·u`` (slew: ``u − u_last``), ``Cxu = 0``, with J the
  feature Jacobian;
* the regularized backward step shared with K4 (``csrc/bwd_step.cuh``).

The first two run on producer warps, a chunk of steps ahead, into shared
memory; one consumer warp walks the backward recursion over them (the staged
backward of ``csrc/bwd_step.cuh``), 16 instances to a block.

The plain version expands the same trajectory with ``core/diff`` (the
``torch.func`` route of the scan engine) and runs K4's plain backward on it.
"""

from __future__ import annotations

import ctypes

import torch
from torch import Tensor

from ..kernels import _build
from .cuda_lqr import _ilqr_backward_plain, check_lanes, pack_lanes
from .cuda_rollout import env_kernel_args
from .diff import _quadratize_delta, linearize_dynamics_delta


def fused_backward_plain(env, xref_l, uref_l, ulast_l, xT_l, weighting, lam_l, reg):
    T = xref_l.shape[0]
    xs = torch.cat([xref_l, xT_l[None]], dim=0).permute(2, 0, 1)   # (Np, T+1, dx)
    us = uref_l.permute(2, 0, 1)                                     # (Np, T, du)
    zero = torch.zeros_like(us[:, :1])
    u_pad = torch.cat([us, zero], dim=1)
    u_last = torch.cat([ulast_l.permute(2, 0, 1), us[:, -1:]], dim=1)
    A, B = linearize_dynamics_delta(env.dynamics, xs[:, :T], us)
    cost = _quadratize_delta(env.cost, xs, u_pad, u_last, weighting[: T + 1])
    packed = pack_lanes(cost, A, B, xs.shape[0])
    return _ilqr_backward_plain(packed, lam_l, reg)


_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_I, _I, _P] + [_P] * 10 + [_I, _I, _I, _P]


def cuda_ilqr_backward_fused(
    env, xref_l: Tensor, uref_l: Tensor, ulast_l: Tensor, xT_l: Tensor,
    weighting: Tensor, lam_l: Tensor, reg: int = 1,
):
    """Fused backward pass on structure-of-arrays trajectory streams (K1).

    ``xref_l (T, dx, Np)``, ``uref_l``/``ulast_l (T, du, Np)``, ``xT_l (dx,
    Np)``, ``weighting (T+1,)``, ``lam_l (Np,)``; on CUDA tensors ``Np`` is a
    multiple of 32.  Returns ``(K (T, du·dx, Np), kff (T, du, Np), dV (2, Np),
    bad (Np,) bool)``, the contract of K4."""
    if reg not in (1, 2):
        raise ValueError(f"reg must be 1 or 2, got {reg}")
    if not getattr(env, "supports_tile_quadratization", False):
        raise ValueError(
            "the fused backward needs a tile-protocol env with the base "
            f"feature-goal cost; {type(env).__name__} does not qualify"
        )
    if xref_l.device.type == "cpu":
        return fused_backward_plain(env, xref_l, uref_l, ulast_l, xT_l, weighting,
                                    lam_l, reg)
    T, dx, Np = xref_l.shape
    du = uref_l.shape[1]
    check_lanes("K1 fused_backward", Np)
    kind, params = env_kernel_args(env, dx, du)
    w = weighting[: T + 1].contiguous()
    ins = [xref_l, uref_l, ulast_l, xT_l, w, lam_l]
    code = _build.cuda_operands("K1 fused_backward", *ins)
    dev, dt = xref_l.device, xref_l.dtype
    K = torch.empty(T, du * dx, Np, dtype=dt, device=dev)
    kff = torch.empty(T, du, Np, dtype=dt, device=dev)
    dV = torch.empty(2, Np, dtype=dt, device=dev)
    bad = torch.empty(Np, dtype=torch.bool, device=dev)
    fn = _build.function("fused_backward.cu", "trajopt_fused_backward", _ARGTYPES)
    with torch.cuda.device(dev):
        rc = fn(code, kind, ctypes.addressof(params),
                *(t.data_ptr() for t in ins + [K, kff, dV, bad]), T, Np, reg,
                torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "K1 fused_backward")
    cuda_ilqr_backward_fused.launches += 1
    return K, kff, dV, bad


cuda_ilqr_backward_fused.launches = 0
