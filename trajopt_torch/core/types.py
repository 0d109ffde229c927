"""Tensor containers of the port, time-leading like ``trajopt_tpu/core/types.py``.

Shapes are those of the JAX package with any number of leading batch
dimensions in front (the batched solver keeps its instances first).
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch import Tensor


class QuadraticCost(NamedTuple):
    """Stacked quadratic cost; the iLQR (delta) convention holds raw Hessians
    and gradients about the reference point, ``c0`` unused (zeros)."""

    Cxx: Tensor  # (T, dx, dx)
    cx: Tensor   # (T, dx)
    Cuu: Tensor  # (T, du, du)
    cu: Tensor   # (T, du)
    Cxu: Tensor  # (T, dx, du)
    c0: Tensor   # (T,)

    @property
    def horizon(self) -> int:
        return self.Cxx.shape[-3]


class QuadraticValue(NamedTuple):
    """Quadratic state-value function V(x) = xᵀ V x + vᵀ x + v0."""

    V: Tensor   # (T, dx, dx)
    v: Tensor   # (T, dx)
    v0: Tensor  # (T,)


class QuadraticQValue(NamedTuple):
    """Quadratic state-action value blocks."""

    Qxx: Tensor  # (T, dx, dx)
    Quu: Tensor  # (T, du, du)
    Qux: Tensor  # (T, du, dx)
    qx: Tensor   # (T, dx)
    qu: Tensor   # (T, du)
    q0: Tensor   # (T,)


class LinearPolicy(NamedTuple):
    """Time-varying affine controller u = kff + K x."""

    K: Tensor    # (T, du, dx)
    kff: Tensor  # (T, du)

    @property
    def horizon(self) -> int:
        return self.K.shape[-3]


def symmetrize(M: Tensor) -> Tensor:
    """0.5 (M + Mᵀ) over the trailing two axes."""
    return 0.5 * (M + torch.swapaxes(M, -1, -2))
