"""Environment protocol and registry, the counterpart of ``trajopt_tpu/envs/base.py``.

An environment is a frozen dataclass of parameters whose methods are plain
functions on tensors with any leading batch dimensions (state last).  The
tile protocol (``_ode_parts``, ``_periodic_parts``, ``features_parts``) takes
sequences of per-component tensors, as the JAX package's Pallas kernels take
lists of VPU tiles; the CUDA kernels of this package write the same physics
once more as device functions (``csrc/envs.cuh``, ``csrc/bsp.cu``).
``TrajEnv`` is fully observed; ``BeliefEnv`` adds an observation model,
noise covariances and a belief cost for belief-space planning.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from dataclasses import dataclass
from typing import Callable, ClassVar

import torch
from torch import Tensor

from ..utils.psd import cholesky


def clip(x: Tensor, lo: Tensor, hi: Tensor) -> Tensor:
    """``jnp.clip(x, lo, hi)`` with JAX's derivative at the bounds.

    ``jnp.clip`` is max then min, whose derivative splits evenly at a tie, so
    the slope is 1 strictly inside the bounds, 0.5 exactly at a bound and 0
    outside; ``torch.maximum``/``torch.minimum`` split ties the same way in
    both AD modes (``torch.clamp`` gives 1 at a bound).  The rule matters
    because rollouts store clipped actions, so the solver linearizes exactly
    at ±umax on every saturated step.  Built from the two primitives, the
    clip has higher derivatives too (the belief expansion differentiates
    Jacobians of clipped dynamics)."""
    return torch.minimum(torch.maximum(x, lo), hi)


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
    @property
    def ulim(self) -> Tensor:
        """Action limits ``umax`` (float64, CPU)."""
        return torch.tensor(self.umax, dtype=torch.float64)

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

    # -- stochastic interface ------------------------------------------------------
    @property
    def sigma(self) -> Tensor:
        """Process-noise covariance ``sigma_scale·I`` (float64, CPU)."""
        return self.sigma_scale * torch.eye(self.dm_state, dtype=torch.float64)

    @property
    def sigma0(self) -> Tensor:
        """Initial-state covariance ``sigma0_scale·I`` (float64, CPU)."""
        return self.sigma0_scale * torch.eye(self.dm_state, dtype=torch.float64)

    def noise(self, x: Tensor | None = None, u: Tensor | None = None) -> Tensor:
        """Process-noise covariance, in ``x``'s dtype and device when given."""
        return self.sigma if x is None else self.sigma.to(dtype=x.dtype, device=x.device)

    def noise_factor(self, dtype: torch.dtype, device) -> Tensor:
        """``chol(noise())`` in ``dtype`` on ``device``, factored once per env,
        dtype and device (the covariance depends on neither x nor u)."""
        return _noise_factor(self, dtype, torch.device(device))

    def init(self) -> tuple[Tensor, Tensor]:
        """Initial-state distribution ``(x0, sigma0)`` (float64, CPU)."""
        return torch.tensor(self.x0, dtype=torch.float64), self.sigma0

    def sample_init(self, generator: torch.Generator | None = None, *,
                    dtype: torch.dtype = torch.float32, device="cuda") -> Tensor:
        """One draw of the initial state, ``x0 + chol(sigma0) z`` with ``z``
        standard normal from ``generator``."""
        x0, sigma0 = self.init()
        x0 = x0.to(dtype=dtype, device=device)
        return gaussian(x0, cholesky(sigma0.to(dtype=dtype, device=device)), generator)

    def step(self, generator: torch.Generator | None, x: Tensor, u: Tensor,
             noise: Tensor | None = None) -> Tensor:
        """Noisy step: ``dynamics(x, u) + chol(sigma) z`` with ``z`` standard
        normal from ``generator``, or ``dynamics(x, u) + noise`` when the
        additive noise is handed in (so that tests can feed another
        generator's draws).  ``x`` may carry leading batch dimensions."""
        xn = self.dynamics(x, u)
        if noise is not None:
            return xn + noise
        return gaussian(xn, self.noise_factor(x.dtype, x.device), generator)


@functools.lru_cache(maxsize=None)
def _noise_factor(env: TrajEnv, dtype: torch.dtype, device: torch.device) -> Tensor:
    return cholesky(env.noise().to(dtype=dtype, device=device))


def gaussian(mean: Tensor, chol: Tensor, generator: torch.Generator | None) -> Tensor:
    """``mean + chol z`` with ``chol`` the covariance's lower Cholesky factor
    and ``z`` standard normal of ``mean``'s shape, drawn on the generator's
    device (the default generator's when None) and moved to ``mean``'s;
    ``jax.random.multivariate_normal``'s formula."""
    return mean + _matvec(chol, standard_normal(mean.shape, generator, mean.dtype, mean.device))


def _const(values: tuple, dtype: torch.dtype, device: torch.device) -> Tensor:
    """A constant tensor of ``values``, made once per dtype and device so that
    env methods called in loops on the card copy nothing to it.  Inside a
    ``torch.func`` transform a factory's tensor belongs to that transform's
    level, so there it is made afresh and not cached."""
    if torch._C._functorch.peek_interpreter_stack() is not None:
        return torch.tensor(values, dtype=dtype, device=device)
    return _const_cached(values, dtype, torch.device(device))


@functools.lru_cache(maxsize=None)
def _const_cached(values: tuple, dtype: torch.dtype, device: torch.device) -> Tensor:
    return torch.tensor(values, dtype=dtype, device=device)


def _scaled_eye(scale: float, n: int, dtype: torch.dtype, device: torch.device) -> Tensor:
    """``scale·I`` of size n (``scale * jnp.eye(n)``)."""
    return _const(tuple(tuple(scale if i == j else 0.0 for j in range(n)) for i in range(n)),
                  dtype, device)


@dataclass(frozen=True)
class BeliefEnv:
    """Base partially-observed environment (counterpart of
    ``trajopt_tpu/envs/base.py::BeliefEnv``): dynamics, observation model,
    noise covariances and a belief cost, on tensors with any leading batch
    dimensions.  Subclasses define ``_ode_parts`` (RK4 dynamics) or override
    ``dynamics``.

    ``supports_belief_tiles`` is True when ``csrc/bsp.cu`` holds the env's
    device functions, which the single-launch BSP kernels K9/K10 run (the
    port's counterpart of the JAX env's tile protocol).  The kernels hold
    LightDark's only.
    """

    dt: float
    state_dim: int
    belief_dim: int
    obs_dim: int
    act_dim: int

    supports_belief_tiles: ClassVar[bool] = False

    def replace(self, **kwargs) -> "BeliefEnv":
        return dataclasses.replace(self, **kwargs)

    @property
    def xlim(self) -> Tensor:
        """State limits ``xmax`` (float64, CPU)."""
        return torch.tensor(self.xmax, dtype=torch.float64)

    @property
    def ulim(self) -> Tensor:
        """Action limits ``umax`` (float64, CPU)."""
        return torch.tensor(self.umax, dtype=torch.float64)

    def clip_act(self, u: Tensor) -> Tensor:
        b = _const(self.umax, u.dtype, u.device)
        return clip(u, -b, b)

    def clip_state(self, x: Tensor) -> Tensor:
        b = _const(self.xmax, x.dtype, x.device)
        return clip(x, -b, b)

    def _ode_parts(self, x, u) -> tuple:
        raise NotImplementedError(
            f"{type(self).__name__} does not define component-wise dynamics"
        )

    def _ode(self, x: Tensor, u: Tensor) -> Tensor:
        return torch.cat(self._ode_parts(_parts(x), _parts(u)), dim=-1)

    def dynamics(self, x: Tensor, u: Tensor) -> Tensor:
        """Clip the action, one RK4 step of the ODE, clip the state."""
        return self.clip_state(rk4(self._ode, x, self.clip_act(u), self.dt))

    @property
    def dyn_sigma(self) -> Tensor:
        """Process-noise covariance ``dyn_sigma_scale·I`` (float64, CPU)."""
        return self.dyn_sigma_scale * torch.eye(self.state_dim, dtype=torch.float64)

    @property
    def obs_sigma(self) -> Tensor:
        """Observation-noise floor ``obs_sigma_scale·I`` (float64, CPU)."""
        return self.obs_sigma_scale * torch.eye(self.obs_dim, dtype=torch.float64)

    def dyn_noise(self, x: Tensor, u: Tensor | None = None) -> Tensor:
        """Process-noise covariance in ``x``'s dtype and device."""
        return _scaled_eye(float(self.dyn_sigma_scale), self.state_dim, x.dtype, x.device)

    def obs_noise(self, x: Tensor) -> Tensor:
        """Observation-noise covariance at ``x (..., dx)`` → ``(..., do, do)``."""
        eye = _scaled_eye(float(self.obs_sigma_scale), self.obs_dim, x.dtype, x.device)
        return eye.expand(*x.shape[:-1], self.obs_dim, self.obs_dim)

    def observe(self, x: Tensor) -> Tensor:
        return x

    def cost(self, mu_b: Tensor, sigma_b: Tensor, u: Tensor) -> Tensor:
        """Belief cost (μ−g)ᵀdiag(μw)(μ−g) + tr(diag(Σw)·Σ) + uᵀdiag(Rw)u
        (lightdark.py:76-79, car.py:95-99), over any leading batch axes."""
        g = _const(self.goal, mu_b.dtype, mu_b.device)
        mw = _const(self.mu_w, mu_b.dtype, mu_b.device)
        sw = _const(self.sigma_w, mu_b.dtype, mu_b.device)
        aw = _const(self.act_w, u.dtype, u.device)
        d = mu_b - g
        return ((d * mw * d).sum(-1) + (sw * torch.diagonal(sigma_b, dim1=-2, dim2=-1)).sum(-1)
                + (u * aw * u).sum(-1))

    def step(self, generator: torch.Generator | None, x: Tensor, u: Tensor,
             normals: tuple[Tensor, Tensor] | None = None) -> tuple[Tensor, Tensor]:
        """Noisy step returning (next state, noisy observation): each a draw
        ``mean + chol(cov) ε`` (lightdark.py:85-100), with the standard
        normals ``ε`` from ``generator`` or handed in as ``normals =
        (ε_dyn (..., dx), ε_obs (..., do))``."""
        if normals is None:
            normals = (standard_normal(x.shape, generator, x.dtype, x.device),
                       standard_normal((*x.shape[:-1], self.obs_dim), generator, x.dtype,
                                       x.device))
        xn = chol_draw(self.dynamics(x, u), self.dyn_noise(x, u), normals[0])
        return xn, chol_draw(self.observe(xn), self.obs_noise(xn), normals[1])


def standard_normal(shape, generator: torch.Generator | None, dtype: torch.dtype,
                    device) -> Tensor:
    """Standard normals of ``shape``, drawn on the generator's device (the
    default generator's when None) and moved to ``device``."""
    where = generator.device if generator is not None else device
    return torch.randn(shape, generator=generator, dtype=dtype, device=where).to(device)


def chol_draw(mean: Tensor, cov: Tensor, eps: Tensor) -> Tensor:
    """``mean + chol(cov) ε``: the multivariate-normal draw with its
    standard normals handed in."""
    return mean + _matvec(cholesky(cov), eps)


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
