"""Small SPD helpers (counterpart of ``trajopt_tpu/utils/psd.py``).

The JAX package derives divergence flags from Cholesky factors:
``jnp.linalg.cholesky`` yields NaN for a non-PD input.  :func:`cholesky` keeps
that contract, so the engines built on it flag the same problems.
"""

from __future__ import annotations

import torch
from torch import Tensor


def cholesky(S: Tensor) -> Tensor:
    """Lower Cholesky factor of each matrix of ``S (..., n, n)``, all NaN where
    the factorization fails (``jnp.linalg.cholesky``'s contract)."""
    L, info = torch.linalg.cholesky_ex(S)
    return torch.where((info != 0)[..., None, None], torch.nan, L)


def chol_solve(chol: Tensor, b: Tensor) -> Tensor:
    """Solve (L Lᵀ) x = b given the lower Cholesky factor L; ``b`` is a
    vector ``(..., n)`` or a matrix ``(..., n, m)``."""
    vec = b.dim() == chol.dim() - 1
    B = b.unsqueeze(-1) if vec else b
    y = torch.linalg.solve_triangular(chol, B, upper=False)
    x = torch.linalg.solve_triangular(chol.mT, y, upper=True)
    return x.squeeze(-1) if vec else x


def inv_psd(M: Tensor) -> Tensor:
    """Inverse of each symmetric positive-definite matrix of ``M (..., n, n)``
    through its Cholesky factor (NaN where the factorization fails)."""
    eye = torch.eye(M.shape[-1], dtype=M.dtype, device=M.device)
    return chol_solve(cholesky(M), eye.expand(M.shape))


def logdet_psd(M: Tensor) -> Tensor:
    """log det of each SPD matrix of ``M (..., n, n)`` through its Cholesky
    factor (NaN where the factorization fails)."""
    return 2.0 * torch.log(torch.diagonal(cholesky(M), dim1=-2, dim2=-1)).sum(-1)
