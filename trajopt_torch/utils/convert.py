"""Carry environments and solver states across from the JAX package.

Plain Python and numpy values only: nothing here imports ``trajopt_tpu``.
A caller turns a JAX env into ``dataclasses.asdict(env)`` and a JAX
``ILQRState`` into a dict of numpy arrays.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..envs.base import make
from ..parallel.mpc import ILQRState


def _plain(v):
    if isinstance(v, (np.ndarray, list, tuple)):
        return tuple(_plain(e) for e in v)
    if isinstance(v, np.generic):
        return v.item()
    return v


def env_from_fields(env_id: str, fields: dict):
    """The port's ``env_id`` with the given dataclass fields of the JAX env."""
    env = make(env_id)
    known = {f.name for f in dataclasses.fields(env)}
    unknown = set(fields) - known
    if unknown:
        raise ValueError(f"{env_id} has no fields {sorted(unknown)}")
    return dataclasses.replace(env, **{k: _plain(v) for k, v in fields.items()})


def ilqr_state_from_numpy(d: dict, *, device="cuda") -> ILQRState:
    """A state given as numpy arrays (keys: the ``ILQRState`` fields) → the
    port's state on ``device``, dtypes kept (``done`` as bool)."""
    def conv(name):
        t = torch.as_tensor(np.array(d[name]))
        return (t.to(torch.bool) if name == "done" else t).to(device)

    return ILQRState(*(conv(name) for name in ILQRState._fields))


def ilqr_state_to_numpy(state: ILQRState) -> dict:
    """The port's state → a dict of numpy arrays keyed by field."""
    return {k: v.detach().cpu().numpy() for k, v in state._asdict().items()}
