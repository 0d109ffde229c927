"""Batched linearization and quadratization (counterpart of ``trajopt_tpu/core/diff.py``).

One ``torch.func.vmap`` of ``jacfwd``/``hessian`` over every (instance, time)
pair.  Inputs carry any leading batch dimensions before the time axis.
"""

from __future__ import annotations

from typing import Callable

import torch
from torch import Tensor
from torch.func import grad, hessian, jacfwd, vmap

from ..envs.base import _matvec
from .types import LinearDynamics, QuadraticCost


def _pad_actions(us: Tensor) -> tuple[Tensor, Tensor]:
    """Return (u, u_last) sequences of length T+1 for cost expansion: one zero
    column pads the end of u, and u_last at t = 0 is zero."""
    zero = torch.zeros_like(us[..., :1, :])
    return torch.cat([us, zero], dim=-2), torch.cat([zero, us], dim=-2)


def _quad(x: Tensor, M: Tensor, y: Tensor) -> Tensor:
    """xᵀ M y over the trailing axes, as ``(x @ M) @ y``."""
    return ((x.unsqueeze(-2) @ M).squeeze(-2) * y).sum(-1)


def linearize_dynamics(f: Callable, xs: Tensor, us: Tensor) -> LinearDynamics:
    """First-order expansion with residual, f(x, u) ≈ A x + B u + c, at each
    (x, u) of ``xs (..., dx)``, ``us (..., du)`` (absolute convention)."""
    A, B = linearize_dynamics_delta(f, xs, us)
    return LinearDynamics(A=A, B=B, c=f(xs, us) - _matvec(A, xs) - _matvec(B, us))


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
        # one Hessian and one gradient over (x, u) give every block
        def cost_xu(xu):
            return cost(xu[:dx], xu[dx:], ul, a)

        xu = torch.cat([x, u])
        H, g = hessian(cost_xu)(xu), grad(cost_xu)(xu)
        return H[:dx, :dx], H[dx:, dx:], H[:dx, dx:], g[:dx], g[dx:]

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


def quadratize_cost_abs(
    cost: Callable, xs: Tensor, us: Tensor, weights: Tensor
) -> QuadraticCost:
    """Origin-recentred absolute-convention quadratic with ½-scaled Hessians:
    cost(x, u) ≈ xᵀCxx x + uᵀCuu u + 2 xᵀCxu u + cxᵀx + cuᵀu + c0 about each
    point.  ``xs (..., T+1, dx)``, ``us (..., T, du)``, ``weights (T+1,)``."""
    u_pad, u_last = _pad_actions(us)
    raw = _quadratize_delta(cost, xs, u_pad, u_last, weights)
    Cxx, Cuu, Cxu = 0.5 * raw.Cxx, 0.5 * raw.Cuu, 0.5 * raw.Cxu
    cx = raw.cx - _matvec(raw.Cxx, xs) - _matvec(raw.Cxu, u_pad)
    cu = raw.cu - _matvec(raw.Cuu, u_pad) - _matvec(raw.Cxu.mT, xs)
    c0 = (
        cost(xs, u_pad, u_last, weights.expand(xs.shape[:-1]))
        - _quad(xs, Cxx, xs)
        - _quad(u_pad, Cuu, u_pad)
        - 2.0 * _quad(xs, Cxu, u_pad)
        - (cx * xs).sum(-1)
        - (cu * u_pad).sum(-1)
    )
    return QuadraticCost(Cxx=Cxx, cx=cx, Cuu=Cuu, cu=cu, Cxu=Cxu, c0=c0)


def evaluate_quadratic_cost(cost: QuadraticCost, xs: Tensor, us: Tensor) -> Tensor:
    """Σ_t xᵀCxx x + uᵀCuu u + 2xᵀCxu u + cxᵀx + cuᵀu + c0 over the horizon,
    the actions zero-padded at the terminal step; ``xs (..., T+1, dx)``,
    ``us (..., T, du)`` → ``(...)``."""
    u_pad, _ = _pad_actions(us)
    quad = (
        _quad(xs, cost.Cxx, xs)
        + _quad(u_pad, cost.Cuu, u_pad)
        + 2.0 * _quad(xs, cost.Cxu, u_pad)
        + (xs * cost.cx).sum(-1)
        + (u_pad * cost.cu).sum(-1)
        + cost.c0
    )
    return quad.sum(-1)


def quadratize_cost_elqr(cost: Callable, x: Tensor, u: Tensor):
    """eLQR-convention quadratization at single points (x, u) with u_last = 0
    and a = 1: cost(x, u) ≈ xᵀCxx x + uᵀCuu u + xᵀCxu u + cxᵀx + cuᵀu + c0
    with Cxx = ½H_xx and Cuu = ½H_uu but Cxu = H_xu unscaled, so the cross
    terms count once.  ``x (..., dx)``, ``u (..., du)`` with equal leading
    shapes; returns ``(Cxx, Cuu, Cxu, cx, cu, c0)``."""
    dx, du = x.shape[-1], u.shape[-1]
    lead = x.shape[:-1]

    def cost_xu(xu):
        return cost(xu[:dx], xu[dx:], torch.zeros_like(xu[dx:]),
                    torch.ones((), dtype=xu.dtype, device=xu.device))

    def expand(xu):
        # one Hessian and one gradient over (x, u) give every block
        return hessian(cost_xu)(xu), grad(cost_xu)(xu), cost_xu(xu)

    H, g, c = vmap(expand)(torch.cat([x, u], -1).reshape(-1, dx + du))
    H, g, c = H.reshape(lead + H.shape[1:]), g.reshape(lead + g.shape[1:]), c.reshape(lead)
    H_xx, H_uu, H_xu = H[..., :dx, :dx], H[..., dx:, dx:], H[..., :dx, dx:]
    g_x, g_u = g[..., :dx], g[..., dx:]
    Cxx, Cuu, Cxu = 0.5 * H_xx, 0.5 * H_uu, H_xu
    cx = g_x - _matvec(H_xx, x) - _matvec(H_xu, u)
    cu = g_u - _matvec(H_uu, u) - _matvec(H_xu.mT, x)
    c0 = (c - _quad(x, Cxx, x) - _quad(u, Cuu, u) - _quad(x, Cxu, u)
          - (cx * x).sum(-1) - (cu * u).sum(-1))
    return Cxx, Cuu, Cxu, cx, cu, c0
