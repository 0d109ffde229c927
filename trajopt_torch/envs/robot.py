"""Kinematic bicycle robot (counterpart of ``trajopt_tpu/envs/robot.py``),
the env of the robust-GPS examples.

The reference integrates its forward dynamics with backward RK4 signs
(envs/robot/robot.py:62-67), so ``dynamics`` is ``rk4_backward``; the cost is
dt-scaled and the bounds are infinite.  No device functions are written for
it yet (ROADMAP.md queue 1, row 14), so it does not opt into the tile
protocol, and the iLQR and eLQR kernel engines refuse it.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import Tensor

from .base import TrajEnv, register, rk4_backward

_INF = float("inf")


@dataclass(frozen=True)
class Robot(TrajEnv):
    """State (x, y, θ, v), action (acceleration, steering angle)."""

    dt: float = 0.025
    dm_state: int = 4
    dm_act: int = 2

    length: float = 0.1

    x0: tuple = (5.0, 5.0, 0.0, 0.0)
    g: tuple = (0.0, 0.0, 0.0, 0.0)
    gw: tuple = (1e1, 1e1, 1.0, 1.0)
    uw: tuple = (1e-3, 1e-3)

    umax: tuple = (_INF, _INF)
    xmax: tuple = (_INF, _INF, _INF, _INF)

    sigma_scale: float = 1e-8
    sigma0_scale: float = 1e-4

    slew_rate: bool = False

    def _ode(self, x: Tensor, u: Tensor) -> Tensor:
        """State (x, y, θ, v), action (accel, steer) — robot.py:54-61."""
        v, th, steer = x[..., 3:4], x[..., 2:3], u[..., 1:2]
        return torch.cat([v * torch.cos(th), v * torch.sin(th),
                          v * torch.tan(steer) / float(self.length), u[..., 0:1]], dim=-1)

    def dynamics(self, x: Tensor, u: Tensor) -> Tensor:
        u = self.clip_act(u)
        return self.clip_state(rk4_backward(self._ode, x, u, self.dt))

    def cost(self, x: Tensor, u: Tensor, u_last: Tensor, a: Tensor) -> Tensor:
        kw = dict(dtype=x.dtype, device=x.device)
        uw, g, gw = (torch.tensor(v, **kw) for v in (self.uw, self.g, self.gw))
        d = x - g
        c = (u * uw * u).sum(-1) + ((a.unsqueeze(-1) * d) * gw * d).sum(-1)
        return self.dt * c



register("Robot-TO-v0", Robot)
