"""Extended-Kalman propagation through a nonlinear env under a linear-Gaussian
controller (counterpart of ``trajopt_tpu/core/ekf.py::extended_kalman``).

One loop over time for the mean path, one batched ``torch.func``
linearization along it, one loop for the covariance recursion.  Any leading
batch dimensions run together.
"""

from __future__ import annotations

import torch
from torch import Tensor

from ..envs.base import _matvec, clip
from .diff import linearize_dynamics
from .types import GaussianSequence, LinearGaussianDynamics, LinearGaussianPolicy, symmetrize


def extended_kalman(
    env, policy: LinearGaussianPolicy, mu0: Tensor, sigma0: Tensor,
) -> tuple[GaussianSequence, GaussianSequence, LinearGaussianDynamics]:
    """Propagate N(mu0, sigma0) through the env's mean dynamics and the EKF
    covariance recursion, relinearizing along the mean path
    (gps/objects.py:179-212).

    Action means are clipped to the env's limits (with ``jnp.clip``'s
    derivative at a bound) and covariances symmetrized each step.  ``policy``
    stacks ``(..., T, ...)``, ``mu0 (..., dx)``, ``sigma0 (..., dx, dx)``.
    Returns (xdist (T+1), udist (T), the linear-Gaussian dynamics (T)).
    """
    T = policy.horizon
    ulim = env.ulim.to(dtype=mu0.dtype, device=mu0.device)

    mu, mus, us = mu0, [], []
    for t in range(T):
        u = clip(_matvec(policy.K[..., t, :, :], mu) + policy.kff[..., t, :], -ulim, ulim)
        mus.append(mu)
        us.append(u)
        mu = env.dynamics(mu, u)
    axis = mu0.dim() - 1
    mu_xs, mu_us = torch.stack(mus, dim=axis), torch.stack(us, dim=axis)

    lin = linearize_dynamics(env.dynamics, mu_xs, mu_us)
    sigma_dyn = env.noise(mu0).expand(lin.A.shape)

    sigma_x, sigs_x, sigs_u = sigma0, [], []
    for t in range(T):
        A, B, K = lin.A[..., t, :, :], lin.B[..., t, :, :], policy.K[..., t, :, :]
        u_sigma = symmetrize(policy.sigma[..., t, :, :] + K @ sigma_x @ K.mT)
        AB = torch.cat([A, B], dim=-1)
        cross = sigma_x @ K.mT
        sigma_xu = torch.cat([torch.cat([sigma_x, cross], dim=-1),
                              torch.cat([cross.mT, u_sigma], dim=-1)], dim=-2)
        sigs_x.append(sigma_x)
        sigs_u.append(u_sigma)
        sigma_x = symmetrize(sigma_dyn[..., t, :, :] + AB @ sigma_xu @ AB.mT)

    xdist = GaussianSequence(
        mu=torch.cat([mu_xs, mu.unsqueeze(-2)], dim=-2),
        sigma=torch.stack(sigs_x + [sigma_x], dim=axis),
    )
    udist = GaussianSequence(mu=mu_us, sigma=torch.stack(sigs_u, dim=axis))
    lgd = LinearGaussianDynamics(A=lin.A, B=lin.B, c=lin.c, sigma=sigma_dyn)
    return xdist, udist, lgd
