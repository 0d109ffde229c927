"""Pendulum swing-up environments (counterpart of ``trajopt_tpu/envs/pendulum.py``).

The ODE keeps the reference's own expression, ``sin(θ + π)`` rather than
``−sin θ``, so that float64 results agree with the JAX package to rounding.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
from torch import Tensor

from .base import TrajEnv, _parts, register, wrap_angle

_INF = float("inf")


@dataclass(frozen=True)
class Pendulum(TrajEnv):
    """Torque-limited pendulum, RK4-discretized.  State (θ, θ̇) with θ = 0
    upright; x0 = (π, 0), hanging down."""

    dt: float = 0.01
    dm_state: int = 2
    dm_act: int = 1

    g: tuple = (0.0, 0.0)
    gw: tuple = (1e0, 1e-1)
    uw: tuple = (1e-3,)
    umax: tuple = (10.0,)
    xmax: tuple = (_INF, _INF)
    x0: tuple = (3.141592653589793, 0.0)

    sigma_scale: float = 1e-4
    sigma0_scale: float = 1e-4

    slew_rate: bool = False
    periodic: bool = False

    def _ode_parts(self, x, u) -> tuple:
        grav, m, l, k = 9.81, 1.0, 1.0, 1e-3
        th, dth = x[0], x[1]
        ddth = -3.0 * grav / (2.0 * l) * torch.sin(th + math.pi) + 3.0 / (m * l**2) * (
            u[0] - k * dth
        )
        return (dth, ddth)

    def _periodic_parts(self, x) -> tuple:
        if self.periodic:
            return (wrap_angle(x[0]), x[1])
        return (x[0], x[1])

    def _periodic_state(self, x: Tensor) -> Tensor:
        if self.periodic:
            return torch.cat(self._periodic_parts(_parts(x)), dim=-1)
        return x


@dataclass(frozen=True)
class PendulumWithCartesianCost(Pendulum):
    """Cartesian feature cost variant: features (cos θ, sin θ, θ̇) with goal
    (1, 0, 0) and weights (1e4, 1e4, 1e0)."""

    g: tuple = (1.0, 0.0, 0.0)
    gw: tuple = (1e4, 1e4, 1e0)

    def features_parts(self, x) -> tuple:
        return (torch.cos(x[0]), torch.sin(x[0]), x[1])

    def features(self, x: Tensor) -> Tensor:
        return torch.cat(self.features_parts(_parts(x)), dim=-1)


register("Pendulum-TO-v0", Pendulum)
register("Pendulum-TO-v1", PendulumWithCartesianCost)
