"""Shared solver machinery (counterpart of ``trajopt_tpu/solvers/common.py``):
activation weighting and the tracking rollout."""

from __future__ import annotations

import numpy as np
import torch
from torch import Tensor

from ..core.types import LinearPolicy

DEFAULT_ALPHAS = tuple(np.power(10.0, np.linspace(0, -3, 11)))


def make_weighting(
    nb_steps: int, activation: dict | None, *, device="cuda", dtype=torch.float32
) -> Tensor:
    """Cost-activation schedule: ``None`` → ones; {'mult','shift'} → sigmoid
    ramp; {'discount'} → γ^t."""
    kw = dict(dtype=dtype, device=device)
    if activation is None:
        return torch.ones(nb_steps + 1, **kw)
    if "mult" in activation and "shift" in activation:
        t = torch.linspace(0, nb_steps, nb_steps + 1, **kw)
        return 1.0 / (1.0 + torch.exp(-activation["mult"] * (t - activation["shift"])))
    if "discount" in activation:
        w = torch.ones(nb_steps + 1, **kw)
        w[1:] = torch.cumprod(activation["discount"] * torch.ones(nb_steps, **kw), dim=0)
        return w
    raise NotImplementedError(f"unknown activation spec {activation}")


def rollout_tracking(
    env, policy: LinearPolicy, alpha, x0: Tensor, xref: Tensor, uref: Tensor,
    weighting: Tensor,
) -> tuple[Tensor, Tensor, Tensor]:
    """Deterministic rollout under the tracking controller
    u = uref + α·kff + K (x − xref), clipped to the action limits.

    Any leading batch dimensions run together: ``K (..., T, du, dx)``,
    ``kff (..., T, du)``, ``alpha`` broadcastable to ``(...)``, ``x0 (..., dx)``,
    ``xref (..., T+1, dx)``, ``uref (..., T, du)``.  The stage cost uses the
    *previous* action as ``u_last`` (zero at t = 0).  Returns (states
    (..., T+1, dx), actions (..., T, du), costs (..., T+1)).
    """
    T = policy.horizon
    alpha = torch.as_tensor(alpha, dtype=x0.dtype, device=x0.device).unsqueeze(-1)
    x = x0
    u_prev = torch.zeros_like(uref[..., 0, :])
    xs, us, cs = [], [], []
    for t in range(T):
        K, kff = policy.K[..., t, :, :], policy.kff[..., t, :]
        xr, ur = xref[..., t, :], uref[..., t, :]
        u = ur + alpha * kff + (K @ (x - xr).unsqueeze(-1)).squeeze(-1)
        u = env.clip_act(u)
        cs.append(env.cost(x, u, u_prev, weighting[t]))
        xs.append(x)
        us.append(u)
        x = env.dynamics(x, u)
        u_prev = u
    zero = torch.zeros_like(u_prev)
    cs.append(env.cost(x, zero, zero, weighting[T]))
    xs.append(x)
    return torch.stack(xs, dim=-2), torch.stack(us, dim=-2), torch.stack(cs, dim=-1)
