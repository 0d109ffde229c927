"""Light-dark 2D navigation with state-dependent observation noise
(counterpart of ``trajopt_tpu/envs/lightdark.py``), the canonical BSP-iLQR
benchmark."""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import Tensor

from .base import BeliefEnv, _const, _scaled_eye, clip, register

_INF = float("inf")


def light_dark_noise(env: BeliefEnv, x: Tensor) -> Tensor:
    """``obs_sigma_scale·I`` plus ½(5 − x₀)² on the first channel: the noise
    grows quadratically with the distance from the light at x₀ = 5
    (lightdark.py:70-73, car.py:86-89).  ``x (..., dx)`` → ``(..., 2, 2)``."""
    floor = _scaled_eye(float(env.obs_sigma_scale), 2, x.dtype, x.device)
    e00 = _const(((1.0, 0.0), (0.0, 0.0)), x.dtype, x.device)
    d = 5.0 - x[..., :1]    # a unit axis: see envs/base.py::_parts
    return floor + (0.5 * d * d)[..., None] * e00


@dataclass(frozen=True)
class LightDark(BeliefEnv):
    """Single integrator in the plane, observed with noise that is small only
    near x₀ = 5."""

    dt: float = 1.0
    state_dim: int = 2
    belief_dim: int = 2
    obs_dim: int = 2
    act_dim: int = 2

    goal: tuple = (0.0, 0.0)
    mu_w: tuple = (0.5, 0.5)
    sigma_w: tuple = (200.0, 0.0)
    act_w: tuple = (0.5, 0.5)

    xmax: tuple = (7.0, 4.0)
    umax: tuple = (_INF, _INF)

    dyn_sigma_scale: float = 1e-8
    obs_sigma_scale: float = 1e-4

    supports_belief_tiles = True

    def dynamics(self, x: Tensor, u: Tensor) -> Tensor:
        """Single integrator, clipped (lightdark.py:56-60)."""
        u = self.clip_act(u)
        b = _const(self.xmax, x.dtype, x.device)
        return clip(x + self.dt * u, -b, b)

    def obs_noise(self, x: Tensor) -> Tensor:
        return light_dark_noise(self, x)

    def init(self) -> tuple[Tensor, Tensor]:
        """Initial belief: wide x-uncertainty (lightdark.py:103-107)."""
        mu = torch.tensor([2.0, 2.0], dtype=torch.float64)
        sigma = torch.tensor([[5.0, 0.0], [0.0, 1e-8]], dtype=torch.float64)
        return mu, sigma

    def reset_state(self) -> Tensor:
        return torch.tensor([2.5, 0.0], dtype=torch.float64)


register("LightDark-TO-v0", LightDark)
