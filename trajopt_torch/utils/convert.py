"""Carry environments and solver states across from the JAX package.

Plain Python and numpy values only: nothing here imports ``trajopt_tpu``.
A caller turns a JAX env into ``dataclasses.asdict(env)``, a JAX
``ILQRState`` or ``BSPState`` into a dict of numpy arrays, and a JAX
``GPSState`` into a dict whose container fields (``ctl``, ``xdist``,
``dyn``, ``cost``) are dicts of numpy arrays keyed by their own fields, and
a ``LinearPolicy`` or ``QuadraticValue`` (an eLQR controller or value
function) into a dict of numpy arrays keyed by field.  A JAX ``RGPSState``
goes across as a ``GPSState`` does (its containers ``ctl``, ``xdist``,
``udist``, ``cost``, ``nominal`` as dicts; its PRNG key, which serves only
the ``mf`` variant, is left behind), a ``MatrixNormalParams`` as a dict.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.types import (
    GaussianSequence,
    LinearGaussianDynamics,
    LinearGaussianPolicy,
    LinearPolicy,
    MatrixNormalParams,
    QuadraticCost,
    QuadraticValue,
)
from ..envs.base import make
from ..parallel.bsp import BSPState
from ..parallel.gps import GPSState
from ..parallel.mpc import ILQRState
from ..parallel.rgps import RGPSState

_GPS_PARTS = {"ctl": LinearGaussianPolicy, "xdist": GaussianSequence,
              "dyn": LinearGaussianDynamics, "cost": QuadraticCost}
_RGPS_PARTS = {"ctl": LinearGaussianPolicy, "xdist": GaussianSequence,
               "udist": GaussianSequence, "cost": QuadraticCost, "nominal": MatrixNormalParams}


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
    return _nested_state(GPSState, _GPS_PARTS, d, device)


def gps_state_to_numpy(state: GPSState) -> dict:
    """The port's GPS state → nested dicts of numpy arrays, as
    :func:`gps_state_from_numpy` takes them."""
    return _nested_to_numpy(state, _GPS_PARTS)


def rgps_state_from_numpy(d: dict, *, device="cuda") -> RGPSState:
    """A robust-GPS state given as numpy arrays (keys: the ``RGPSState``
    fields, the containers as dicts of their own fields; other keys, such
    as the JAX state's ``key``, are ignored) → the port's state on
    ``device``, dtypes and shapes kept: unbatched from ``make_rgps_solver``,
    batch-leading from ``make_rgps_solver_batched``."""
    return _nested_state(RGPSState, _RGPS_PARTS, d, device)


def rgps_state_to_numpy(state: RGPSState) -> dict:
    """The port's robust-GPS state → nested dicts of numpy arrays, as
    :func:`rgps_state_from_numpy` takes them."""
    return _nested_to_numpy(state, _RGPS_PARTS)


def matrix_normal_from_numpy(d: dict, *, device="cuda") -> MatrixNormalParams:
    """A MatrixNormal given as numpy arrays (keys ``mu``, ``sigma``) → the
    port's ``MatrixNormalParams`` on ``device``, dtypes and shapes kept."""
    return _flat_state(MatrixNormalParams, d, device)


def matrix_normal_to_numpy(param: MatrixNormalParams) -> dict:
    """The port's MatrixNormal → a dict of numpy arrays keyed by field."""
    return _flat_to_numpy(param)


def _nested_state(cls, parts: dict, d: dict, device):
    def conv(x):
        return torch.as_tensor(np.array(x)).to(device)

    fields = {}
    for name in cls._fields:
        part = parts.get(name)
        value = d[name]
        fields[name] = part(*(conv(value[f]) for f in part._fields)) if part else conv(value)
    return cls(**fields)


def _nested_to_numpy(state, parts: dict) -> dict:
    def conv(x):
        return x.detach().cpu().numpy()

    return {name: ({f: conv(x) for f, x in value._asdict().items()}
                   if name in parts else conv(value))
            for name, value in state._asdict().items()}


def linear_policy_from_numpy(d: dict, *, device="cuda") -> LinearPolicy:
    """A controller given as numpy arrays (keys ``K``, ``kff``) → the port's
    ``LinearPolicy`` on ``device``, dtypes and shapes kept."""
    return _flat_state(LinearPolicy, d, device)


def linear_policy_to_numpy(ctl: LinearPolicy) -> dict:
    """The port's controller → a dict of numpy arrays keyed by field."""
    return _flat_to_numpy(ctl)


def quadratic_value_from_numpy(d: dict, *, device="cuda") -> QuadraticValue:
    """A value function given as numpy arrays (keys ``V``, ``v``, ``v0``) →
    the port's ``QuadraticValue`` on ``device``, dtypes and shapes kept."""
    return _flat_state(QuadraticValue, d, device)


def quadratic_value_to_numpy(value: QuadraticValue) -> dict:
    """The port's value function → a dict of numpy arrays keyed by field."""
    return _flat_to_numpy(value)
