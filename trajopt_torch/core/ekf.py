"""Extended-Kalman filtering (counterpart of ``trajopt_tpu/core/ekf.py``).

* :func:`extended_kalman`: propagation through a nonlinear env under a
  linear-Gaussian controller: one loop over time for the mean path, one
  batched ``torch.func`` linearization along it, one loop for the covariance
  recursion.
* :func:`belief_ekf_step` and :class:`EKF`: the belief dynamics of BSP-iLQR
  and the filter of its MPC loop, with Joseph-form covariance updates.

Any leading batch dimensions run together.  The Jacobians of the env's
dynamics and observation model come from ``torch.func.jacfwd``, so these
functions can themselves be differentiated in forward mode (the belief
expansion takes a Jacobian of :func:`belief_ekf_step`).
"""

from __future__ import annotations

import torch
from torch import Tensor

from torch.func import jacfwd, vmap

from ..envs.base import _matvec, clip
from ..utils.psd import inv_psd
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


def _jacobian(fn, x: Tensor, *args: Tensor) -> Tensor:
    """∂fn/∂x at ``x (..., n)`` (``args`` with the same leading axes):
    ``jacfwd`` of one point, mapped over the flattened leading axes."""
    if x.dim() == 1:
        return jacfwd(fn)(x, *args)
    lead = x.shape[:-1]
    flat = [a.reshape(-1, a.shape[-1]) for a in (x, *args)]
    J = vmap(jacfwd(fn))(*flat)
    return J.reshape(*lead, *J.shape[1:])


def _eye_like(M: Tensor) -> Tensor:
    return torch.eye(M.shape[-1], dtype=M.dtype, device=M.device)


def _jitter(M: Tensor) -> Tensor:
    """1e-5 (tr M / n + 1e-12) I, the relative jitter of both float32 floors.
    The trace keeps a unit axis: under ``torch.func`` a 0-d tensor times a
    Python float turns float64."""
    scale = torch.diagonal(M, dim1=-2, dim2=-1).sum(-1, keepdim=True) / M.shape[-1] + 1e-12
    return (1e-5 * scale)[..., None] * _eye_like(M)


def _psd_floor(M: Tensor) -> Tensor:
    """Relative diagonal floor, float32 only (a no-op in float64, where the
    reference's own 1e-8 noise floors suffice).

    Belief envs observe some channels without noise, so the posterior
    covariance collapses to exact singularity in float32, and differentiating
    the next EKF step through its Cholesky factor would give NaN Jacobians.
    """
    if M.dtype != torch.float32:
        return M
    return M + _jitter(M)


def _inv(S: Tensor) -> Tensor:
    """Innovation-covariance inverse through its Cholesky factor.

    In float32 a relative jitter is added first: the belief envs' 1e-8
    absolute noise floor (car.py:86-89) underflows against O(1) covariances
    in float32 and leaves S exactly singular on the channels the light-dark
    profile keeps noiseless.  The jitter is zero in float64.
    """
    S = symmetrize(S)
    if S.dtype == torch.float32:
        S = S + _jitter(S)
    return inv_psd(S)


def _joseph(P: Tensor, K: Tensor, H: Tensor, R: Tensor) -> Tensor:
    """Joseph form of the updated covariance, (I − KH) P (I − KH)ᵀ + K R Kᵀ,
    symmetrized and floored: equal to P − KHP for the optimal gain, and
    positive semi-definite in float32 too, where the plain difference
    cancels."""
    I_KH = _eye_like(P) - K @ H
    return _psd_floor(symmetrize(I_KH @ P @ I_KH.mT + K @ R @ K.mT))


def belief_ekf_step(env, mu_b: Tensor, sigma_b: Tensor, u: Tensor):
    """One EKF predict and gain step of the belief dynamics: returns
    (f, W, Φ) = (mean dynamics, the Kalman update's covariance KHD, the
    predicted-minus-update covariance D − KHD in Joseph form)
    (bspilqr/objects.py:213-233).  ``mu_b (..., b)``, ``sigma_b (..., b, b)``,
    ``u (..., a)``."""
    A = _jacobian(env.dynamics, mu_b, u)
    f = env.dynamics(mu_b, u)
    H = _jacobian(env.observe, f)
    sigma_obs = env.obs_noise(f)

    D = symmetrize(A @ sigma_b @ A.mT + env.dyn_noise(mu_b, u))
    S = H @ D @ H.mT + sigma_obs
    K = D @ H.mT @ _inv(S)
    W = K @ H @ D
    return f, W, _joseph(D, K, H, sigma_obs)


class EKF:
    """The classic EKF over a belief env (bspilqr/objects.py:24-73), the
    filter of the BSP-iLQR MPC loop (examples/bspilqr/lightdark.py:34-45)."""

    def __init__(self, env):
        self.env = env

    def predict(self, mu_b: Tensor, sigma_b: Tensor, u: Tensor):
        A = _jacobian(self.env.dynamics, mu_b, u)
        sigma = symmetrize(A @ sigma_b @ A.mT + self.env.dyn_noise(mu_b, u))
        return self.env.dynamics(mu_b, u), sigma

    def innovate(self, mu_b: Tensor, sigma_b: Tensor, z: Tensor):
        H = _jacobian(self.env.observe, mu_b)
        R = self.env.obs_noise(mu_b)
        S = H @ sigma_b @ H.mT + R
        K = sigma_b @ H.mT @ _inv(S)
        mu = mu_b + _matvec(K, z - self.env.observe(mu_b))
        return mu, _joseph(sigma_b, K, H, R)

    def inference(self, mu_b: Tensor, sigma_b: Tensor, u: Tensor, z: Tensor):
        mu_b, sigma_b = self.predict(mu_b, sigma_b, u)
        return self.innovate(mu_b, sigma_b, z)
