"""Line-search rollouts as CUDA kernels (K2, K3).

Counterpart of ``trajopt_tpu/core/pallas_rollout.py``:

* :func:`cuda_rollout_returns` (K2, ``_returns_kernel``): phase A, every α
  candidate rolled out at once, one lane per (α, instance); only the
  per-candidate returns and the ``x < 1e8`` flags are written.
* :func:`cuda_rollout_selected` (K3, ``_selected_kernel``): phase B, each
  instance rolls out again under its own selected α and writes the states and
  actions that become the next reference trajectory.

Both kernels are staged (``csrc/ring.cuh``): a producer warp copies the next
chunk of the streams into shared memory while the consumer lanes walk the
time loop over the chunk before, so they take whole groups of instances
(``Np`` a multiple of 32, as ``lane_pad`` makes it) and 16-byte aligned
streams.

Both take the structure-of-arrays streams of ``cuda_lqr`` — ``K (T, du·dx,
Np)``, ``kff (T, du, Np)``, ``xref (T, dx, Np)`` (row 0 is the start state),
``uref (T, du, Np)`` — and the weighting ``(T+1,)``.  CUDA tensors launch
``csrc/rollout.cu``; CPU tensors run the plain versions below, which step the
tile-level physics (``tile_dynamics``/``tile_cost``) over all lanes.
"""

from __future__ import annotations

import ctypes
import math

import torch
from torch import Tensor

from ..kernels import _build
from .cuda_lqr import check_lanes, to_soa

# --------------------------------------------------------------------------------------
# Tile-level env physics: sequences of per-component tensors
# --------------------------------------------------------------------------------------


def tile_clip_act(env, u):
    return [torch.clamp(u[j], -float(env.umax[j]), float(env.umax[j]))
            for j in range(len(u))]


def tile_clip_state(env, x):
    return [
        xi if float(env.xmax[i]) == math.inf
        else torch.clamp(xi, -float(env.xmax[i]), float(env.xmax[i]))
        for i, xi in enumerate(x)
    ]


def tile_dynamics(env, x, u):
    """``env.dynamics`` on parts: clip action, RK4 over ``_ode_parts``, clip state."""
    dt = float(env.dt)
    u = tile_clip_act(env, u)
    f = env._ode_parts
    n = len(x)
    k1 = f(x, u)
    k2 = f([x[i] + (0.5 * dt) * k1[i] for i in range(n)], u)
    k3 = f([x[i] + (0.5 * dt) * k2[i] for i in range(n)], u)
    k4 = f([x[i] + dt * k3[i] for i in range(n)], u)
    xn = [
        x[i] + (dt / 6.0) * (k1[i] + 2.0 * k2[i] + 2.0 * k3[i] + k4[i])
        for i in range(n)
    ]
    return tile_clip_state(env, xn)


def tile_cost(env, x, u, u_last, w):
    """``env.cost`` on parts: ``uᵀdiag(uw)u`` (or the slew form) plus
    ``w·(z−g)ᵀdiag(gw)(z−g)`` with z = features(x), which is what the
    detached-Jacobian feature cost evaluates to at its expansion point."""
    from ..envs.base import TrajEnv

    if type(env).cost is not TrajEnv.cost:
        return env.cost_parts(x, u, u_last, w)
    uw = tuple(float(v) for v in env.uw)
    if env.slew_rate:
        c = sum(uw[j] * (u[j] - u_last[j]) ** 2 for j in range(len(u)))
    else:
        c = sum(uw[j] * u[j] * u[j] for j in range(len(u)))
    z = env.features_parts(env._periodic_parts(x))
    g = tuple(float(v) for v in env.g)
    gw = tuple(float(v) for v in env.gw)
    return c + w * sum(gw[i] * (z[i] - g[i]) ** 2 for i in range(len(z)))


# --------------------------------------------------------------------------------------
# Env constants for the kernels (csrc/envs.cuh EnvParams)
# --------------------------------------------------------------------------------------


class EnvParams(ctypes.Structure):
    """Mirror of ``struct EnvParams`` in csrc/envs.cuh: the env's fields reach
    the kernels as a launch argument, so ``make(..., dt=…)`` overrides work."""

    _fields_ = [
        ("dt", ctypes.c_double),
        ("g", ctypes.c_double * 8),
        ("gw", ctypes.c_double * 8),
        ("uw", ctypes.c_double * 4),
        ("umax", ctypes.c_double * 4),
        ("xmax", ctypes.c_double * 8),
        ("slew_rate", ctypes.c_int),
        ("periodic", ctypes.c_int),
    ]


def env_kernel_args(env, dx: int, du: int) -> tuple[int, EnvParams]:
    """(env kind, EnvParams) for the C entry points: kind 0 is Cartpole
    (identity features), 1 is Cartpole with the Cartesian (cos/sin) cost.
    Raises unless the streams' ``dx``/``du`` are the env's."""
    from ..envs.cartpole import Cartpole, CartpoleWithCartesianCost

    kinds = {Cartpole: 0, CartpoleWithCartesianCost: 1}
    kind = kinds.get(type(env))
    if kind is None:
        raise ValueError(f"no CUDA kernel is written for {type(env).__name__}")
    if (dx, du) != (env.dm_state, env.dm_act):
        raise ValueError(f"streams have dx={dx}, du={du}; {type(env).__name__} "
                         f"has {env.dm_state}, {env.dm_act}")
    p = EnvParams(
        dt=float(env.dt), slew_rate=int(bool(env.slew_rate)),
        periodic=int(bool(env.periodic)),
    )
    for name in ("g", "gw", "uw", "umax", "xmax"):
        vals = tuple(float(v) for v in getattr(env, name))
        getattr(p, name)[: len(vals)] = vals
    return kind, p


# --------------------------------------------------------------------------------------
# Plain PyTorch versions
# --------------------------------------------------------------------------------------


def _rollout_plain(env, K, kff, xref, uref, weighting, alpha, keep_traj):
    """Roll out ``u = ur + α·kff + K(x − xr)`` for every lane of ``alpha`` —
    ``(nA, Np)`` for phase A, ``(Np,)`` for phase B — with the same step order
    as the kernels: finite check, action, clip, stage cost with the previous
    action, RK4."""
    T, dx, Np = xref.shape
    du = uref.shape[1]
    shape = alpha.shape
    x = [xref[0, c].expand(shape) for c in range(dx)]
    uprev = [torch.zeros(shape, dtype=xref.dtype, device=xref.device)] * du
    ret = torch.zeros(shape, dtype=xref.dtype, device=xref.device)
    ok = torch.ones(shape, dtype=torch.bool, device=xref.device)
    xs, us = [], []
    for t in range(T):
        for c in range(dx):
            ok = ok & (x[c] < 1e8)
        u = [
            uref[t, j] + alpha * kff[t, j]
            + sum(K[t, j * dx + c] * (x[c] - xref[t, c]) for c in range(dx))
            for j in range(du)
        ]
        u = tile_clip_act(env, u)
        ret = ret + tile_cost(env, x, u, uprev, weighting[t])
        if keep_traj:
            xs.append(torch.stack(x))
            us.append(torch.stack(u))
        x = tile_dynamics(env, x, u)
        uprev = u
    zeros = [torch.zeros_like(ret)] * du
    ret = ret + tile_cost(env, x, zeros, zeros, weighting[T])
    for c in range(dx):
        ok = ok & (x[c] < 1e8)
    if keep_traj:
        return torch.stack(xs), torch.stack(us), torch.stack(x), ret
    return ret, ok


def rollout_returns_plain(env, K, kff, xref, uref, weighting, alphas):
    return _rollout_plain(env, K, kff, xref, uref, weighting,
                          alphas[:, None].expand(-1, xref.shape[2]), False)


def rollout_selected_plain(env, K, kff, xref, uref, weighting, alpha_l):
    return _rollout_plain(env, K, kff, xref, uref, weighting, alpha_l, True)


# --------------------------------------------------------------------------------------
# Kernel wrappers
# --------------------------------------------------------------------------------------

_P, _I = ctypes.c_void_p, ctypes.c_int
_RET_ARGTYPES = [_I, _I, _P] + [_P] * 8 + [_I, _I, _I, _P]
_SEL_ARGTYPES = [_I, _I, _P] + [_P] * 10 + [_I, _I, _P]


def _dims(K, xref, uref):
    T, dx, Np = xref.shape
    du = uref.shape[1]
    if K.shape != (T, du * dx, Np) or uref.shape != (T, du, Np):
        raise ValueError(
            f"stream shapes disagree: K {tuple(K.shape)}, xref {tuple(xref.shape)}, "
            f"uref {tuple(uref.shape)}"
        )
    return T, dx, du, Np


def _check_aligned(what, *streams):
    if any(t.data_ptr() % 16 for t in streams):
        # the kernel stages the streams with 16-byte cp.async copies
        raise ValueError(f"{what}: the streams must be 16-byte aligned")


def cuda_rollout_returns(env, K, kff, xref, uref, weighting, alphas):
    """Phase A (K2): returns ``(returns (nA, Np), ok (nA, Np) bool)`` for the
    whole α grid ``alphas (nA,)``, any ``nA >= 1``; ``ok`` is the
    states-below-1e8 flag over the whole trajectory (NaN clears it).  CUDA
    tensors launch the kernel (``Np`` a multiple of 32); CPU tensors run the
    plain version on any ``Np``."""
    T, dx, du, Np = _dims(K, xref, uref)
    if xref.device.type == "cpu":
        return rollout_returns_plain(env, K, kff, xref, uref, weighting, alphas)
    check_lanes("K2 rollout_returns", Np)
    kind, params = env_kernel_args(env, dx, du)
    w = weighting[: T + 1].contiguous()
    ins = [K, kff, xref, uref, w, alphas]
    code = _build.cuda_operands("K2 rollout_returns", *ins)
    _check_aligned("K2 rollout_returns", K, kff, xref, uref)
    nA = alphas.shape[0]
    ret = torch.empty(nA, Np, dtype=xref.dtype, device=xref.device)
    ok = torch.empty(nA, Np, dtype=torch.bool, device=xref.device)
    fn = _build.function("rollout.cu", "trajopt_rollout_returns", _RET_ARGTYPES)
    with torch.cuda.device(xref.device):
        rc = fn(code, kind, ctypes.addressof(params),
                *(t.data_ptr() for t in ins + [ret, ok]), T, Np, nA,
                torch.cuda.current_stream(xref.device).cuda_stream)
    _build.check(rc, "K2 rollout_returns")
    cuda_rollout_returns.launches += 1
    return ret, ok


def cuda_rollout_selected(env, K, kff, xref, uref, weighting, alpha_l):
    """Phase B (K3): roll out each lane's own ``alpha_l (Np,)``.  Returns
    ``(states (T, dx, Np) [pre-step], actions (T, du, Np), xT (dx, Np),
    returns (Np,))``.  CUDA tensors launch the kernel (``Np`` a multiple of
    32); CPU tensors run the plain version on any ``Np``."""
    T, dx, du, Np = _dims(K, xref, uref)
    if xref.device.type == "cpu":
        return rollout_selected_plain(env, K, kff, xref, uref, weighting, alpha_l)
    check_lanes("K3 rollout_selected", Np)
    kind, params = env_kernel_args(env, dx, du)
    w = weighting[: T + 1].contiguous()
    ins = [K, kff, xref, uref, w, alpha_l]
    code = _build.cuda_operands("K3 rollout_selected", *ins)
    _check_aligned("K3 rollout_selected", K, kff, xref, uref)
    kw = dict(dtype=xref.dtype, device=xref.device)
    xs = torch.empty(T, dx, Np, **kw)
    us = torch.empty(T, du, Np, **kw)
    xT = torch.empty(dx, Np, **kw)
    ret = torch.empty(Np, **kw)
    fn = _build.function("rollout.cu", "trajopt_rollout_selected", _SEL_ARGTYPES)
    with torch.cuda.device(xref.device):
        rc = fn(code, kind, ctypes.addressof(params),
                *(t.data_ptr() for t in ins + [xs, us, xT, ret]), T, Np,
                torch.cuda.current_stream(xref.device).cuda_stream)
    _build.check(rc, "K3 rollout_selected")
    cuda_rollout_selected.launches += 1
    return xs, us, xT, ret


cuda_rollout_returns.launches = 0
cuda_rollout_selected.launches = 0


def pack_rollout(K: Tensor, kff: Tensor, xref: Tensor, uref: Tensor, n_pad: int):
    """Batch-leading ``K (N, T, du, dx)``, ``kff (N, T, du)``, ``xref (N, T+1,
    dx)``, ``uref (N, T, du)`` → the kernels' streams (K, kff, xref, uref)."""
    T = K.shape[1]
    return (to_soa(K, n_pad), to_soa(kff, n_pad), to_soa(xref[:, :T], n_pad),
            to_soa(uref, n_pad))


def unpack_selected(states_l: Tensor, actions_l: Tensor, xT_l: Tensor, N: int):
    """Phase-B outputs → batch-leading ``(states (N, T+1, dx), actions (N, T, du))``."""
    states = torch.cat([states_l, xT_l[None]], dim=0)[..., :N].permute(2, 0, 1)
    return states, actions_l[..., :N].permute(2, 0, 1)
