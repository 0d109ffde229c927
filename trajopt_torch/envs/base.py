"""Environment protocol and registry, the counterpart of ``trajopt_tpu/envs/base.py``.

An environment is a frozen dataclass of parameters whose methods are plain
functions on tensors with any leading batch dimensions (state last).  The
tile protocol (``_ode_parts``, ``_periodic_parts``, ``features_parts``) takes
sequences of per-component tensors, as the JAX package's Pallas kernels take
lists of VPU tiles; the CUDA kernels of this package write the same physics
once more as device functions (``csrc/envs.cuh``).
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Callable

import torch
from torch import Tensor


class _Clip(torch.autograd.Function):
    """Clamp with JAX's tie rule: ``jnp.clip`` is max/min, whose derivative
    splits evenly at a tie, so the slope is 1 strictly inside the bounds, 0.5
    exactly at a bound and 0 outside.  ``torch.clamp`` gives 1 at a bound.
    The rule matters because rollouts store clipped actions, so the solver
    linearizes exactly at ±umax on every saturated step."""

    generate_vmap_rule = True

    @staticmethod
    def forward(x, lo, hi):
        return torch.clamp(x, lo, hi)

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, lo, hi = inputs
        inside = (x > lo) & (x < hi)
        tie = (x == lo) | (x == hi)
        slope = torch.where(inside, 1.0, torch.where(tie, 0.5, 0.0)).to(x.dtype)
        ctx.save_for_backward(slope)
        ctx.save_for_forward(slope)

    @staticmethod
    def backward(ctx, grad):
        (slope,) = ctx.saved_tensors
        return grad * slope, None, None

    @staticmethod
    def jvp(ctx, x_t, lo_t, hi_t):
        (slope,) = ctx.saved_tensors
        return x_t * slope


def clip(x: Tensor, lo: Tensor, hi: Tensor) -> Tensor:
    """``jnp.clip(x, lo, hi)`` with JAX's derivative at the bounds."""
    return _Clip.apply(x, lo, hi)


def wrap_angle(x: Tensor) -> Tensor:
    """Wrap angle to [-π, π): JAX's floored ``%`` (fmod, then shift a negative
    remainder by the divisor)."""
    two_pi = 2.0 * math.pi
    r = torch.fmod(x + math.pi, two_pi)
    return torch.where(r < 0, r + two_pi, r) - math.pi


def rk4(f: Callable, x: Tensor, u: Tensor, dt: float) -> Tensor:
    """Classic RK4 step used by every analytic env."""
    k1 = f(x, u)
    k2 = f(x + 0.5 * dt * k1, u)
    k3 = f(x + 0.5 * dt * k2, u)
    k4 = f(x + dt * k3, u)
    return x + dt / 6.0 * (k1 + 2.0 * k2 + 2.0 * k3 + k4)


def _parts(x: Tensor) -> tuple[Tensor, ...]:
    """Components of ``x (..., d)`` as ``(..., 1)`` tensors for the tile
    protocol.  Keeping the unit axis matters: under ``torch.func.jacfwd`` a
    0-d component times a Python float is promoted to float64."""
    return x.split(1, dim=-1)


def _matvec(M: Tensor, x: Tensor) -> Tensor:
    return (M @ x.unsqueeze(-1)).squeeze(-1)


@dataclass(frozen=True)
class TrajEnv:
    """Base fully-observed environment. Subclasses define ``_ode_parts``."""

    dt: float
    dm_state: int
    dm_act: int

    def replace(self, **kwargs) -> "TrajEnv":
        return dataclasses.replace(self, **kwargs)

    # -- limits ------------------------------------------------------------------
    def clip_act(self, u: Tensor) -> Tensor:
        b = torch.tensor(self.umax, dtype=u.dtype, device=u.device)
        return clip(u, -b, b)

    def clip_state(self, x: Tensor) -> Tensor:
        b = torch.tensor(self.xmax, dtype=x.dtype, device=x.device)
        return clip(x, -b, b)

    # -- tile-level protocol (component-wise physics) ------------------------------
    def _ode_parts(self, x, u) -> tuple:
        raise NotImplementedError(
            f"{type(self).__name__} does not define component-wise dynamics"
        )

    def _ode(self, x: Tensor, u: Tensor) -> Tensor:
        return torch.cat(self._ode_parts(_parts(x), _parts(u)), dim=-1)

    def _periodic_parts(self, x) -> tuple:
        """Component-wise ``_periodic_state`` (identity unless periodic)."""
        if getattr(self, "periodic", False):
            raise NotImplementedError(
                f"{type(self).__name__} is periodic but defines no _periodic_parts"
            )
        return tuple(x[i] for i in range(self.dm_state))

    def features_parts(self, x) -> tuple:
        """Component-wise ``features`` (identity by default)."""
        return tuple(x[i] for i in range(self.dm_state))

    def cost_parts(self, x, u, u_last, w):
        """``cost`` on parts, only for envs that override ``cost``."""
        raise NotImplementedError(
            f"{type(self).__name__} does not define a tile-level cost"
        )

    @property
    def supports_tiles(self) -> bool:
        """True when the env opts into the tile protocol: ``_ode_parts`` is
        defined and every overridden array method has its parts twin."""
        cls = type(self)
        if cls._ode_parts is TrajEnv._ode_parts:
            return False
        if (cls.features is not TrajEnv.features
                and cls.features_parts is TrajEnv.features_parts):
            return False
        if (cls._periodic_state is not TrajEnv._periodic_state
                and cls._periodic_parts is TrajEnv._periodic_parts):
            return False
        if (cls.cost is not TrajEnv.cost
                and cls.cost_parts is TrajEnv.cost_parts):
            return False
        return True

    @property
    def supports_tile_quadratization(self) -> bool:
        """True when the closed-form cost quadratization of the fused backward
        applies: tile protocol plus the base feature-goal cost."""
        return self.supports_tiles and type(self).cost is TrajEnv.cost

    # -- core protocol -----------------------------------------------------------
    def dynamics(self, x: Tensor, u: Tensor) -> Tensor:
        u = self.clip_act(u)
        return self.clip_state(rk4(self._ode, x, u, self.dt))

    def features(self, x: Tensor) -> Tensor:
        return x

    def _periodic_state(self, x: Tensor) -> Tensor:
        return x

    def _feature_jacobian(self, y0: Tensor) -> Tensor:
        jac = torch.func.jacfwd(self.features)
        if y0.dim() == 1:
            return jac(y0)
        flat = torch.func.vmap(jac)(y0.reshape(-1, y0.shape[-1]))
        return flat.reshape(*y0.shape[:-1], *flat.shape[-2:])

    def _feature_goal_cost(self, x: Tensor, a: Tensor) -> Tensor:
        """Goal cost through the detached-Jacobian feature linearization: the
        feature map is linearized around detach(y), so the cost curvature
        comes only from the quadratic form (``detach`` is JAX's
        ``stop_gradient`` here, inside ``torch.func`` transforms too)."""
        y = self._periodic_state(x)
        y0 = y.detach()
        J = self._feature_jacobian(y0)
        z = _matvec(J, y) + (self.features(y0) - _matvec(J, y0))
        g = torch.tensor(self.g, dtype=x.dtype, device=x.device)
        gw = torch.tensor(self.gw, dtype=x.dtype, device=x.device)
        d = z - g
        return ((a.unsqueeze(-1) * d) * gw * d).sum(-1)

    def cost(self, x: Tensor, u: Tensor, u_last: Tensor, a: Tensor) -> Tensor:
        uw = torch.tensor(self.uw, dtype=u.dtype, device=u.device)
        if self.slew_rate:
            du = u - u_last
            c = (du * uw * du).sum(-1)
        else:
            c = (u * uw * u).sum(-1)
        return c + self._feature_goal_cost(x, a)


# ---------------------------------------------------------------------------------
# Registry: the same ids as trajopt_tpu
# ---------------------------------------------------------------------------------

_REGISTRY: dict[str, Callable[[], object]] = {}


def register(name: str, ctor: Callable[[], object]) -> None:
    _REGISTRY[name] = ctor


def make(name: str, **overrides):
    """Instantiate a registered environment, optionally overriding fields."""
    if name not in _REGISTRY:
        raise KeyError(f"unknown env '{name}'; known: {sorted(_REGISTRY)}")
    env = _REGISTRY[name]()
    if overrides:
        env = dataclasses.replace(env, **overrides)
    return env


def registered() -> list[str]:
    return sorted(_REGISTRY)
