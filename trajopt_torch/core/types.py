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


class LinearDynamics(NamedTuple):
    """Affine dynamics x' = A x + B u + c, stacked over the horizon."""

    A: Tensor  # (T, dx, dx)
    B: Tensor  # (T, dx, du)
    c: Tensor  # (T, dx)

    @property
    def horizon(self) -> int:
        return self.A.shape[-3]


class LinearGaussianDynamics(NamedTuple):
    """Affine dynamics with Gaussian process noise, x' ~ N(A x + B u + c, sigma)."""

    A: Tensor      # (T, dx, dx)
    B: Tensor      # (T, dx, du)
    c: Tensor      # (T, dx)
    sigma: Tensor  # (T, dx, dx)

    @property
    def horizon(self) -> int:
        return self.A.shape[-3]


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


class LinearGaussianPolicy(NamedTuple):
    """Time-varying linear-Gaussian controller u ~ N(kff + K x, sigma)."""

    K: Tensor      # (T, du, dx)
    kff: Tensor    # (T, du)
    sigma: Tensor  # (T, du, du)

    @property
    def horizon(self) -> int:
        return self.K.shape[-3]


class GaussianSequence(NamedTuple):
    """A sequence of Gaussian marginals."""

    mu: Tensor     # (T, d)
    sigma: Tensor  # (T, d, d)

    @property
    def horizon(self) -> int:
        return self.mu.shape[-2]


class MatrixNormalParams(NamedTuple):
    """Gaussian over θ = vec([A B c]) (column-major vec), stacked over the
    horizon; ``p = dx (dx + du + 1)``."""

    mu: Tensor     # (T, p)
    sigma: Tensor  # (T, p, p)

    @property
    def horizon(self) -> int:
        return self.mu.shape[-2]


def matrices_from_vec(mu_t: Tensor, dx: int, du: int) -> tuple[Tensor, Tensor, Tensor]:
    """Unpack column-major vec([A B c]) ``(..., p)`` into ``A (..., dx, dx)``,
    ``B (..., dx, du)``, ``c (..., dx)``: entry ``a·dx + i`` is row i of
    column a, so each block is the transpose of a row-major reshape."""
    lead = mu_t.shape[:-1]
    A = mu_t[..., : dx * dx].reshape(*lead, dx, dx).mT
    B = mu_t[..., dx * dx : dx * dx + dx * du].reshape(*lead, du, dx).mT
    return A, B, mu_t[..., dx * dx + dx * du :]


def vec_from_matrices(A: Tensor, B: Tensor, c: Tensor) -> Tensor:
    """Column-major vec([A B c]) ``(..., p)``, the inverse of
    :func:`matrices_from_vec`."""
    ABc = torch.cat([A, B, c.unsqueeze(-1)], dim=-1)
    return ABc.mT.reshape(*ABc.shape[:-2], -1)


def symmetrize(M: Tensor) -> Tensor:
    """0.5 (M + Mᵀ) over the trailing two axes."""
    return 0.5 * (M + torch.swapaxes(M, -1, -2))
