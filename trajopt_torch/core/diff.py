"""Batched linearization and quadratization (counterpart of ``trajopt_tpu/core/diff.py``).

One ``torch.func.vmap`` of ``jacfwd``/``hessian`` over every (instance, time)
pair.  Inputs carry any leading batch dimensions before the time axis.
"""

from __future__ import annotations

from typing import Callable

import torch
from torch import Tensor
from torch.func import grad, hessian, jacfwd, jacrev, vmap

from .types import QuadraticCost


def _pad_actions(us: Tensor) -> tuple[Tensor, Tensor]:
    """Return (u, u_last) sequences of length T+1 for cost expansion: one zero
    column pads the end of u, and u_last at t = 0 is zero."""
    zero = torch.zeros_like(us[..., :1, :])
    return torch.cat([us, zero], dim=-2), torch.cat([zero, us], dim=-2)


def linearize_dynamics_delta(f: Callable, xs: Tensor, us: Tensor) -> tuple[Tensor, Tensor]:
    """Jacobians A = ∂f/∂x, B = ∂f/∂u at each (x, u); no residual (iLQR
    convention).  ``xs (..., dx)``, ``us (..., du)`` → ``(..., dx, dx)``,
    ``(..., dx, du)``."""
    dx, du = xs.shape[-1], us.shape[-1]
    lead = xs.shape[:-1]
    A, B = vmap(jacfwd(f, argnums=(0, 1)))(xs.reshape(-1, dx), us.reshape(-1, du))
    return A.reshape(*lead, dx, dx), B.reshape(*lead, dx, du)


def _quadratize_delta(
    cost: Callable, xs: Tensor, u_pad: Tensor, u_last: Tensor, weights: Tensor
) -> QuadraticCost:
    """Raw second-order expansion at each (x, u, u_last, w) of equal leading
    shape."""
    dx, du = xs.shape[-1], u_pad.shape[-1]
    lead = xs.shape[:-1]

    def expand(x, u, ul, a):
        Cxx = hessian(cost, argnums=0)(x, u, ul, a)
        Cuu = hessian(cost, argnums=1)(x, u, ul, a)
        Cxu = jacfwd(jacrev(cost, argnums=0), argnums=1)(x, u, ul, a)
        cx = grad(cost, argnums=0)(x, u, ul, a)
        cu = grad(cost, argnums=1)(x, u, ul, a)
        return Cxx, Cuu, Cxu, cx, cu

    w = weights.expand(lead)
    Cxx, Cuu, Cxu, cx, cu = vmap(expand)(
        xs.reshape(-1, dx), u_pad.reshape(-1, du), u_last.reshape(-1, du),
        w.reshape(-1),
    )
    return QuadraticCost(
        Cxx=Cxx.reshape(*lead, dx, dx), cx=cx.reshape(*lead, dx),
        Cuu=Cuu.reshape(*lead, du, du), cu=cu.reshape(*lead, du),
        Cxu=Cxu.reshape(*lead, dx, du), c0=torch.zeros(lead, dtype=xs.dtype, device=xs.device),
    )


def quadratize_cost_delta(
    cost: Callable, xs: Tensor, us: Tensor, weights: Tensor
) -> QuadraticCost:
    """Raw second-order expansion about the reference trajectory (delta
    coordinates).  ``xs (..., T+1, dx)``, ``us (..., T, du)``, ``weights
    (T+1,)``; returns (T+1)-length stacks, c0 zeros."""
    u_pad, u_last = _pad_actions(us)
    return _quadratize_delta(cost, xs, u_pad, u_last, weights)
