"""Extended LQR (counterpart of ``trajopt_tpu/solvers/elqr.py``).

eLQR keeps quadratic cost-to-go and cost-to-come value functions.  The
forward sweep linearizes the **inverse** dynamics and propagates the
cost-to-come; the backward sweep linearizes the dynamics and propagates the
cost-to-go; at every step the state is re-chosen as the minimizer of the
summed quadratics, so the linearization points depend on the sweep's own
data.  The sweeps here are Python loops over T whose Jacobians and Hessians
come from ``torch.func`` at each step; inverses are ``torch.linalg.inv``, as
the JAX package's are ``jnp.linalg.inv``.  They take any leading batch
dimensions (the batched solver's ``scan`` engine runs them on its instances).
"""

from __future__ import annotations

import torch
from torch import Tensor

from ..core.diff import linearize_dynamics, quadratize_cost_elqr
from ..core.types import LinearPolicy, QuadraticValue
from ..envs.base import _matvec


def _vmv(a: Tensor, M: Tensor, b: Tensor) -> Tensor:
    """(a @ M) @ b over the trailing axes."""
    return ((a.unsqueeze(-2) @ M).squeeze(-2) * b).sum(-1)


def _dot(a: Tensor, b: Tensor) -> Tensor:
    return (a * b).sum(-1)


def _inv(M: Tensor) -> Tensor:
    """``jnp.linalg.inv``'s contract: a singular matrix gives non-finite
    entries, not an error."""
    return torch.linalg.inv_ex(M).inverse


def elqr_cost_eval(env, x: Tensor, u: Tensor) -> Tensor:
    """The cost with u_last = 0 and a = 1."""
    return env.cost(x, u, torch.zeros_like(u), x.new_ones(x.shape[:-1]))


def elqr_rollout(env, ctl: LinearPolicy, x0: Tensor):
    """Deterministic rollout under u = kff + Kx from ``x0 (..., dx)``: states
    ``(..., T+1, dx)``, actions ``(..., T, du)`` and costs ``(..., T+1)``
    (the terminal cost at zero action)."""
    x, xs, us, cs = x0, [], [], []
    for t in range(ctl.kff.shape[-2]):
        u = ctl.kff[..., t, :] + _matvec(ctl.K[..., t, :, :], x)
        xs.append(x)
        us.append(u)
        cs.append(elqr_cost_eval(env, x, u))
        x = env.dynamics(x, u)
    xs.append(x)
    cs.append(elqr_cost_eval(env, x, torch.zeros_like(us[0])))
    return torch.stack(xs, -2), torch.stack(us, -2), torch.stack(cs, -1)


def elqr_forward_lqr(env, state: Tensor, ctl: LinearPolicy, goV: Tensor, gov: Tensor):
    """Forward sweep propagating the cost-to-come through the linearized
    inverse dynamics.  ``goV (..., T+1, dx, dx)``, ``gov (..., T+1, dx)``
    (rows 1 … T read).  Returns ``(state_out, inverse controller, come value
    (T+1 rows, row 0 = 1e-16·I))``."""
    dx = state.shape[-1]
    T = ctl.kff.shape[-2]
    x = state
    comeV = 1e-16 * torch.eye(dx, dtype=x.dtype, device=x.device).expand(*x.shape[:-1], dx, dx)
    comev = torch.zeros_like(x)
    comev0 = x.new_zeros(x.shape[:-1])
    Vs, vs, v0s, iKs, ikffs = [comeV], [comev], [comev0], [], []
    for t in range(T):
        u = ctl.kff[..., t, :] + _matvec(ctl.K[..., t, :, :], x)
        xn = env.dynamics(x, u)
        A, B, c = linearize_dynamics(env.inverse_dynamics, xn, u)
        Cxx, Cuu, Cxu, cx, cu, c0 = quadratize_cost_elqr(env.cost, x, u)

        M = Cxx + comeV
        At, Bt = A.mT, B.mT
        Qxx = At @ M @ A
        Quu = Bt @ M @ B + Bt @ Cxu + Cxu.mT @ B + Cuu
        Qux = Bt @ M @ A + Cxu.mT @ A
        qx = _matvec(At @ M, c) + _matvec(At, cx + comev)
        qu = _matvec(Bt @ M, c) + _matvec(Cxu.mT, c) + _matvec(Bt, cx + comev) + cu
        q0 = _vmv(0.5 * c, M, c) + _dot(c, cx + comev) + c0 + comev0

        Quu_inv = _inv(Quu)
        iKs.append(-Quu_inv @ Qux)
        ikffs.append(_matvec(-Quu_inv, qu))
        comeV = Qxx - Qux.mT @ Quu_inv @ Qux
        comev = qx - _matvec(Qux.mT @ Quu_inv, qu)
        comev0 = q0 - _vmv(0.5 * qu, Quu_inv, qu)
        Vs.append(comeV)
        vs.append(comev)
        v0s.append(comev0)
        x = _matvec(-_inv(goV[..., t + 1, :, :] + comeV), gov[..., t + 1, :] + comev)
    return x, LinearPolicy(K=torch.stack(iKs, -3), kff=torch.stack(ikffs, -2)), QuadraticValue(
        V=torch.stack(Vs, -3), v=torch.stack(vs, -2), v0=torch.stack(v0s, -1))


def elqr_backward_lqr(env, state: Tensor, ictl: LinearPolicy, comeV: Tensor, comev: Tensor,
                      comev0: Tensor):
    """Backward sweep propagating the cost-to-go through the linearized
    dynamics, after the terminal quadratization at (state, 0).  ``comeV
    (..., T+1, dx, dx)``, ``comev (..., T+1, dx)``; ``comev0`` is not read.
    Returns ``(state_out, controller, go value (T+1 rows, row T terminal))``."""
    T = ictl.kff.shape[-2]
    Cxx_T, _, _, cx_T, _, c0_T = quadratize_cost_elqr(
        env.cost, state, state.new_zeros(*state.shape[:-1], env.dm_act))
    goV, gov, gov0 = Cxx_T, cx_T, c0_T
    x = _matvec(-_inv(goV + comeV[..., T, :, :]), gov + comev[..., T, :])
    Vs, vs, v0s, Ks, kffs = [goV], [gov], [gov0], [], []
    for t in range(T - 1, -1, -1):
        u = ictl.kff[..., t, :] + _matvec(ictl.K[..., t, :, :], x)
        xp = env.inverse_dynamics(x, u)
        A, B, c = linearize_dynamics(env.dynamics, xp, u)
        Cxx, Cuu, Cxu, cx, cu, c0 = quadratize_cost_elqr(env.cost, xp, u)

        At, Bt = A.mT, B.mT
        Qxx = Cxx + At @ goV @ A
        Quu = Cuu + Bt @ goV @ B
        Qux = Cxu.mT + Bt @ goV @ A
        qx = cx + _matvec(At @ goV, c) + _matvec(At, gov)
        qu = cu + _matvec(Bt @ goV, c) + _matvec(Bt, gov)
        q0 = c0 + gov0 + _vmv(0.5 * c, goV, c) + _dot(c, gov)

        Quu_inv = _inv(Quu)
        Ks.append(-Quu_inv @ Qux)
        kffs.append(_matvec(-Quu_inv, qu))
        goV = Qxx - Qux.mT @ Quu_inv @ Qux
        gov = qx - _matvec(Qux.mT @ Quu_inv, qu)
        gov0 = q0 - _vmv(0.5 * qu, Quu_inv, qu)
        Vs.append(goV)
        vs.append(gov)
        v0s.append(gov0)
        x = _matvec(-_inv(goV + comeV[..., t, :, :]), gov + comev[..., t, :])
    for seq in (Vs, vs, v0s, Ks, kffs):
        seq.reverse()
    return x, LinearPolicy(K=torch.stack(Ks, -3), kff=torch.stack(kffs, -2)), QuadraticValue(
        V=torch.stack(Vs, -3), v=torch.stack(vs, -2), v0=torch.stack(v0s, -1))


def initial_values(T: int, dx: int, lead: tuple, dtype, device) -> QuadraticValue:
    """The zero value (T+1 rows) with 1e-16·I added at row 0, the initial
    cost-to-go and cost-to-come."""
    V = torch.zeros(*lead, T + 1, dx, dx, dtype=dtype, device=device)
    V[..., 0, :, :] += 1e-16 * torch.eye(dx, dtype=dtype, device=device)
    return QuadraticValue(V=V, v=torch.zeros(*lead, T + 1, dx, dtype=dtype, device=device),
                          v0=torch.zeros(*lead, T + 1, dtype=dtype, device=device))


class eLQR:
    """The host eLQR loop: ``run`` dispatches the three sweeps per iteration.

    The initial controller is K = 0 and kff = ``kff_init (T, du)`` when
    given, else N(0, 1) from ``generator``; the inverse controller draws
    1e-2·N(0, 1) after it, a draw the first forward sweep overwrites unread,
    as in the reference.
    """

    def __init__(self, env, nb_steps: int, init_state, generator: torch.Generator | None = None,
                 kff_init: Tensor | None = None, *, device="cuda", dtype=torch.float32):
        self.env = env
        self.nb_steps = nb_steps
        self.dm_state = dx = env.dm_state
        self.dm_act = du = env.dm_act
        kw = dict(dtype=dtype, device=device)
        self.x0 = torch.as_tensor(init_state, **kw)
        self.xref = torch.zeros(nb_steps + 1, dx, **kw)
        self.xref[0] = self.x0
        self.uref = torch.zeros(nb_steps, du, **kw)

        def normal(shape):
            where = generator.device if generator is not None else device
            return torch.randn(shape, generator=generator, dtype=dtype, device=where).to(device)

        kff = kff_init.to(**kw) if kff_init is not None else normal((nb_steps, du))
        self.ctl = LinearPolicy(K=torch.zeros(nb_steps, du, dx, **kw), kff=kff)
        self.ictl = LinearPolicy(K=torch.zeros(nb_steps, du, dx, **kw),
                                 kff=1e-2 * normal((nb_steps, du)))
        self.gocost = self.comecost = initial_values(nb_steps, dx, (), dtype, device)

    def plot(self, show: bool = True):
        raise NotImplementedError(
            "plotting is not ported yet (ROADMAP.md queue 1, row 16: utils and examples)")

    def run(self, nb_iter: int = 10, verbose: bool = False) -> list[float]:
        """``nb_iter`` iterations of forward sweep, backward sweep and
        evaluation rollout; returns the returns before and after each, and
        leaves the last rollout in ``xref``/``uref``."""
        trace = []
        self.xref, self.uref, cs = elqr_rollout(self.env, self.ctl, self.x0)
        trace.append(float(cs.sum()))
        state = self.x0
        for it in range(nb_iter):
            state, self.ictl, self.comecost = elqr_forward_lqr(
                self.env, state, self.ctl, self.gocost.V, self.gocost.v)
            state, self.ctl, self.gocost = elqr_backward_lqr(
                self.env, state, self.ictl, *self.comecost)
            self.xref, self.uref, cs = elqr_rollout(self.env, self.ctl, self.x0)
            trace.append(float(cs.sum()))
            if verbose:
                print(f"elqr it={it} return={trace[-1]:.6g}")
        return trace
