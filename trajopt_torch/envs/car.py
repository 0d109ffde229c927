"""Partially-observed bicycle-model car (counterpart of
``trajopt_tpu/envs/car.py``): a BSP-iLQR benchmark with position-only
observations and light-dark noise."""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import Tensor

from .base import BeliefEnv, register
from .lightdark import light_dark_noise

_INF = float("inf")


@dataclass(frozen=True)
class Car(BeliefEnv):
    """State (x, y, θ, v), action (acceleration, steering), RK4-discretized.
    The BSP kernels K9/K10 have no device functions for it yet (ROADMAP.md
    queue 1, row 11e); it runs the scan engines and K8."""

    dt: float = 0.5
    state_dim: int = 4
    belief_dim: int = 4
    obs_dim: int = 2
    act_dim: int = 2

    length: float = 0.1  # car length (car.py:24)

    goal: tuple = (0.0, 0.0, 0.0, 0.0)
    mu_w: tuple = (100.0, 100.0, 100.0, 100.0)
    sigma_w: tuple = (100.0, 100.0, 100.0, 100.0)
    act_w: tuple = (1.0, 1.0)

    xmax: tuple = (_INF, _INF, _INF, _INF)
    umax: tuple = (_INF, _INF)

    dyn_sigma_scale: float = 1e-8
    obs_sigma_scale: float = 1e-8

    def _ode_parts(self, x, u) -> tuple:
        """Bicycle model (car.py:62-66)."""
        return (
            x[3] * torch.cos(x[2]),
            x[3] * torch.sin(x[2]),
            x[3] * torch.tan(u[1]) / self.length,
            u[0],
        )

    def observe(self, x: Tensor) -> Tensor:
        """Position-only observation (car.py:78-79)."""
        return x[..., :2]

    def obs_noise(self, x: Tensor) -> Tensor:
        return light_dark_noise(self, x)

    def init(self) -> tuple[Tensor, Tensor]:
        mu = torch.tensor([2.0, 2.0, 0.0, 0.0], dtype=torch.float64)
        return mu, torch.eye(self.belief_dim, dtype=torch.float64)

    def reset_state(self) -> Tensor:
        return torch.tensor([0.0, 4.0, 0.0, 0.0], dtype=torch.float64)


register("Car-TO-v0", Car)
