"""Carry environments and solver states across from the JAX package.

Plain Python and numpy values only: nothing here imports ``trajopt_tpu``.
A caller turns a JAX env into ``dataclasses.asdict(env)``, a JAX
``ILQRState`` or ``BSPState`` into a dict of numpy arrays, and a JAX
``GPSState`` into a dict whose container fields (``ctl``, ``xdist``,
``dyn``, ``cost``) are dicts of numpy arrays keyed by their own fields.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.types import (
    GaussianSequence,
    LinearGaussianDynamics,
    LinearGaussianPolicy,
    QuadraticCost,
)
from ..envs.base import make
from ..parallel.bsp import BSPState
from ..parallel.gps import GPSState
from ..parallel.mpc import ILQRState

_GPS_PARTS = {"ctl": LinearGaussianPolicy, "xdist": GaussianSequence,
              "dyn": LinearGaussianDynamics, "cost": QuadraticCost}


def _plain(v):
    if isinstance(v, (np.ndarray, list, tuple)):
        return tuple(_plain(e) for e in v)
    if isinstance(v, np.generic):
        return v.item()
    return v


def env_from_fields(env_id: str, fields: dict):
    """The port's ``env_id`` (any registered id: Cartpole, Pendulum, LQR,
    LightDark or Car) with the given dataclass fields of the JAX env."""
    env = make(env_id)
    known = {f.name for f in dataclasses.fields(env)}
    unknown = set(fields) - known
    if unknown:
        raise ValueError(f"{env_id} has no fields {sorted(unknown)}")
    return dataclasses.replace(env, **{k: _plain(v) for k, v in fields.items()})


def _flat_state(cls, d: dict, device):
    def conv(name):
        t = torch.as_tensor(np.array(d[name]))
        return (t.to(torch.bool) if name == "done" else t).to(device)

    return cls(*(conv(name) for name in cls._fields))


def _flat_to_numpy(state) -> dict:
    return {k: v.detach().cpu().numpy() for k, v in state._asdict().items()}


def ilqr_state_from_numpy(d: dict, *, device="cuda") -> ILQRState:
    """A state given as numpy arrays (keys: the ``ILQRState`` fields) → the
    port's state on ``device``, dtypes and shapes kept (``done`` as bool):
    unbatched from ``make_ilqr_solver``, batch-leading from
    ``make_ilqr_solver_batched``."""
    return _flat_state(ILQRState, d, device)


def ilqr_state_to_numpy(state: ILQRState) -> dict:
    """The port's state → a dict of numpy arrays keyed by field."""
    return _flat_to_numpy(state)


def bsp_state_from_numpy(d: dict, *, device="cuda") -> BSPState:
    """A BSP-iLQR state given as numpy arrays (keys: the ``BSPState``
    fields) → the port's state on ``device``, dtypes and shapes kept
    (``done`` as bool): unbatched from ``make_bsp_solver``, batch-leading
    from ``make_bsp_solver_batched``."""
    return _flat_state(BSPState, d, device)


def bsp_state_to_numpy(state: BSPState) -> dict:
    """The port's BSP-iLQR state → a dict of numpy arrays keyed by field."""
    return _flat_to_numpy(state)


def gps_state_from_numpy(d: dict, *, device="cuda") -> GPSState:
    """A GPS state given as numpy arrays (keys: the ``GPSState`` fields, the
    containers as dicts of their own fields) → the port's state on
    ``device``, dtypes and shapes kept: unbatched from ``make_mbgps_solver``,
    batch-leading from ``make_mbgps_solver_batched``."""
    def conv(x):
        return torch.as_tensor(np.array(x)).to(device)

    fields = {}
    for name in GPSState._fields:
        part = _GPS_PARTS.get(name)
        value = d[name]
        fields[name] = part(*(conv(value[f]) for f in part._fields)) if part else conv(value)
    return GPSState(**fields)


def gps_state_to_numpy(state: GPSState) -> dict:
    """The port's GPS state → nested dicts of numpy arrays, as
    :func:`gps_state_from_numpy` takes them."""
    def conv(x):
        return x.detach().cpu().numpy()

    return {name: ({f: conv(x) for f, x in value._asdict().items()}
                   if name in _GPS_PARTS else conv(value))
            for name, value in state._asdict().items()}
