"""Linear-quadratic environments (counterpart of ``trajopt_tpu/envs/lqr.py``).

x' = A x + B u + c with a dt-scaled quadratic goal cost.  The adversarial
interface of LQR-TO-v1/v2 (``dynamics_dist``, ``evolve``) belongs to robust
GPS and waits for its slice.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import Tensor

from .base import TrajEnv, _matvec, register, rk4_backward

_INF = float("inf")


@dataclass(frozen=True)
class _LinearEnv(TrajEnv):
    """Shared linear env machinery: x' = A x + B u + c, dt-scaled quadratic cost."""

    dt: float = 0.1
    dm_state: int = 2
    dm_act: int = 1

    x0: tuple = (5.0, 5.0)
    g: tuple = (10.0, 10.0)
    gw: tuple = (1e1, 1e1)
    uw: tuple = (1e0,)

    umax: tuple = (_INF,)
    xmax: tuple = (_INF, _INF)

    sigma_scale: float = 1e-8
    sigma0_scale: float = 1e-2

    slew_rate: bool = False

    def _ABc(self) -> tuple[Tensor, Tensor, Tensor]:
        """The system matrices in float64 on the CPU, per variant."""
        raise NotImplementedError

    def dynamics(self, x: Tensor, u: Tensor) -> Tensor:
        u = self.clip_act(u)
        A, B, c = (m.to(dtype=x.dtype, device=x.device) for m in self._ABc())
        return _matvec(A, x) + _matvec(B, u) + c

    def cost(self, x: Tensor, u: Tensor, u_last: Tensor, a: Tensor) -> Tensor:
        kw = dict(dtype=x.dtype, device=x.device)
        uw, g, gw = (torch.tensor(v, **kw) for v in (self.uw, self.g, self.gw))
        d = x - g
        c = (u * uw * u).sum(-1) + ((a.unsqueeze(-1) * d) * gw * d).sum(-1)
        return self.dt * c

    def inverse_dynamics(self, x: Tensor, u: Tensor) -> Tensor:
        """Backward RK4 of the continuous-map reading of the linear system
        (the reference's eLQR inverse on LQR tasks, not the exact inverse of
        ``dynamics``), clipped at ±xmax."""
        u = self.clip_act(u)
        A, B, c = (m.to(dtype=x.dtype, device=x.device) for m in self._ABc())

        def f(x, u):
            return _matvec(A, x) + _matvec(B, u) + c

        return self.clip_state(rk4_backward(f, x, u, self.dt))

    def dynamics_dist(self, *args, **kwargs) -> Tensor:
        raise NotImplementedError(
            "the adversarial dynamics serve robust GPS, not ported yet "
            "(ROADMAP.md queue 1, row 13)"
        )

    def evolve(self, *args, **kwargs) -> Tensor:
        raise NotImplementedError(
            "the adversarial step serves robust GPS, not ported yet "
            "(ROADMAP.md queue 1, row 13)"
        )


def _f64(x) -> Tensor:
    return torch.tensor(x, dtype=torch.float64)


@dataclass(frozen=True)
class LQRv0(_LinearEnv):
    """Goal-shifted unstable double integrator."""

    def _ABc(self):
        A = _f64([[1.1, 0.0], [1.0, 1.0]])
        B = _f64([[1.0], [0.0]])
        return A, B, -_matvec(A, _f64(self.g))


@dataclass(frozen=True)
class LQRv1(_LinearEnv):
    """dt-discretized mass-spring-damper."""

    dt: float = 0.01
    x0: tuple = (0.0, 0.0)
    g: tuple = (1.0, 0.0)
    gw: tuple = (1e2, 1e0)
    uw: tuple = (1e-3,)
    sigma0_scale: float = 1e-4

    def _ABc(self):
        m, k, d = 1.0, 1e-2, 1e-1
        A = _f64([[0.0, 1.0], [-k / m, -d / m]]) * self.dt + torch.eye(2, dtype=torch.float64)
        B = _f64([[0.0], [1.0 / m]]) * self.dt
        return A, B, torch.zeros(2, dtype=torch.float64)


@dataclass(frozen=True)
class LQRv2(_LinearEnv):
    """Second (unstable) linear variant."""

    dt: float = 0.01
    x0: tuple = (5.0, 5.0)
    g: tuple = (1.0, 0.0)
    gw: tuple = (1e1, 1e0)
    uw: tuple = (1e-3,)
    sigma0_scale: float = 1e-2

    def _ABc(self):
        A = _f64([[1.0, 0.0], [0.1, 1.1]])
        B = _f64([[0.05], [0.0]])
        return A, B, torch.zeros(2, dtype=torch.float64)


register("LQR-TO-v0", LQRv0)
register("LQR-TO-v1", LQRv1)
register("LQR-TO-v2", LQRv2)
