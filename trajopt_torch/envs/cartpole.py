"""Cartpole swing-up environments (counterpart of ``trajopt_tpu/envs/cartpole.py``).

The physics is written once more, for the CUDA kernels, in ``csrc/envs.cuh``.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import Tensor

from .base import TrajEnv, _parts, register, wrap_angle

_INF = float("inf")


@dataclass(frozen=True)
class Cartpole(TrajEnv):
    """Cart-pole, Florian's equations; state (x, θ, ẋ, θ̇)."""

    dt: float = 0.01
    dm_state: int = 4
    dm_act: int = 1

    g: tuple = (0.0, 0.0, 0.0, 0.0)
    gw: tuple = (1e1, 1e4, 1e0, 1e0)
    uw: tuple = (1e-5,)
    umax: tuple = (10.0,)
    xmax: tuple = (10.0, _INF, _INF, _INF)
    x0: tuple = (0.0, 3.141592653589793, 0.0, 0.0)

    sigma_scale: float = 1e-8
    sigma0_scale: float = 1e-4

    slew_rate: bool = False
    periodic: bool = False

    def _ode_parts(self, x, u) -> tuple:
        g = 9.81
        Mc, Mp = 0.37, 0.127
        Mt = Mc + Mp
        l = 0.3365
        fr = 0.005

        _, th, dq, dth = x[0], x[1], x[2], x[3]
        f = u[0]

        sth, cth = torch.sin(th), torch.cos(th)
        num = g * sth + cth * (-(f - fr * dq) - Mp * l * dth**2 * sth) / Mt
        denom = l * (4.0 / 3.0 - Mp * cth**2 / Mt)
        ddth = num / denom
        ddx = (f + Mp * l * (dth**2 * sth - ddth * cth)) / Mt
        return (dq, dth, ddx, ddth)

    def _periodic_parts(self, x) -> tuple:
        if self.periodic:
            return (x[0], wrap_angle(x[1]), x[2], x[3])
        return (x[0], x[1], x[2], x[3])

    def _periodic_state(self, x: Tensor) -> Tensor:
        if self.periodic:
            return torch.cat(self._periodic_parts(_parts(x)), dim=-1)
        return x


@dataclass(frozen=True)
class CartpoleWithCartesianCost(Cartpole):
    """Cartesian feature variant: (x, cos θ, sin θ, ẋ, θ̇)."""

    g: tuple = (0.0, 1.0, 0.0, 0.0, 0.0)
    gw: tuple = (1e1, 1e4, 1e4, 1e0, 1e0)

    def features_parts(self, x) -> tuple:
        return (x[0], torch.cos(x[1]), torch.sin(x[1]), x[2], x[3])

    def features(self, x: Tensor) -> Tensor:
        return torch.cat(self.features_parts(_parts(x)), dim=-1)


register("Cartpole-TO-v0", Cartpole)
register("Cartpole-TO-v1", CartpoleWithCartesianCost)
