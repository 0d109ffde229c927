"""Model-based GPS: the KL-constrained trajectory optimizer and its MPC runners
(counterpart of ``trajopt_tpu/parallel/gps.py``).

One outer iteration: find the dual α whose soft-KL controller moves KL = bound
away from the old one (a bisection on log₁₀ α over [−16, 16]; a diverged
backward pass counts as "α too small"), accept the new controller if its KL
is within a quarter of the bound, then propagate it through the env with the
EKF (``core/ekf``) and quadratize the cost along the mean (``core/diff``).

* :func:`make_mbgps_solver` solves one problem: scalar dual, or the
  per-step dual of ``kl_stepwise=True`` (a damped multiplicative fixed point
  on log α).  It runs as a batch of one on the scan chain of
  ``core/scan_lqr``.
* :func:`make_mbgps_solver_batched` solves a batch, each instance with its own
  bracket, in lockstep and without a host sync.  ``engine="scan"`` runs the
  scan chain for every evaluation; ``engine="cuda"`` packs the operands once
  per dual and evaluates each bisection step as two launches, kernels K6 and
  K7 (``core/cuda_gps``).
* :func:`make_gps_mpc_runner`, :func:`make_gps_mpc_runner_batched` and
  :func:`run_gps_mpc_batch` drive receding-horizon GPS-MPC on the noisy system;
  :func:`gps_mpc_draws` makes the last one's draws.

Random draws (the initial kff = 1e-4·N(0, 1) of each solve, the process noise)
come from a ``torch.Generator`` or are handed in.  On CPU tensors the kernel
wrappers run their plain versions.  The batched iteration marks its phases
for ``torch.profiler`` (``gps.bisect``, ``gps.solution_at``,
``gps.propagate``, ``gps.quadratize``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch import Tensor
from torch.profiler import record_function

from ..core.cuda_gps import (
    cuda_gps_backward_packed,
    cuda_gps_forward_kl_packed,
    pack_gps,
    pack_gps_alpha,
)
from ..core.diff import evaluate_quadratic_cost, quadratize_cost_abs
from ..core.ekf import extended_kalman
from ..core.scan_lqr import augment_cost_kl, gaussian_forward, gps_backward, policy_kl
from ..core.types import (
    GaussianSequence,
    LinearGaussianDynamics,
    LinearGaussianPolicy,
    QuadraticCost,
)
from ..envs.base import _matvec, clip, gaussian
from ..solvers.common import make_weighting
from .mpc import _bcast, _not_ported_mesh, _resolve

LOG_LO, LOG_HI = -16.0, 16.0


class GPSState(NamedTuple):
    """Solver state: unbatched from :func:`make_mbgps_solver`, batch-leading
    from :func:`make_mbgps_solver_batched`."""

    ctl: LinearGaussianPolicy        # (T, …)
    xdist: GaussianSequence          # (T+1, …)
    dyn: LinearGaussianDynamics      # (T, …)
    cost: QuadraticCost              # (T+1, …), absolute convention
    last_return: Tensor              # ()
    kl_mult: Tensor                  # () adaptive bound multiplier
    alpha: Tensor                    # () last dual ((T,) when stepwise)


def _setup(env, nb_steps, activation, slew_rate, action_penalty, device, dtype):
    overrides = {"slew_rate": slew_rate}
    if action_penalty is not None:
        overrides["uw"] = tuple(float(action_penalty) for _ in range(env.dm_act))
    env = env.replace(**overrides)
    kw = dict(dtype=dtype, device=_resolve(device))
    return env, kw, make_weighting(nb_steps, activation, **kw)


def _check_input(mu0: Tensor, kw: dict) -> None:
    if mu0.device != kw["device"] or mu0.dtype != kw["dtype"]:
        raise ValueError(
            f"mu0 is {mu0.dtype} on {mu0.device}; this solver was built for "
            f"{kw['dtype']} on {kw['device']}"
        )


def _propagate(env, weighting, ctl, mu0, sigma0):
    """EKF propagation and the return along the mean (mbgps.py:125-133)."""
    T = ctl.horizon
    xdist, udist, lgd = extended_kalman(env, ctl, mu0, sigma0)
    u_last = torch.cat([torch.zeros_like(udist.mu[..., :1, :]), udist.mu[..., :-1, :]], dim=-2)
    costs = env.cost(xdist.mu[..., :T, :], udist.mu, u_last, weighting[:T])
    zero = torch.zeros_like(udist.mu[..., 0, :])
    c_T = env.cost(xdist.mu[..., T, :], zero, zero, weighting[T])
    return xdist, udist, lgd, costs.sum(-1) + c_T


def _dual_chain(cost, dyn, ctl, alpha, mu0, sigma0):
    """augment → soft-KL backward → Gaussian forward → per-step KL, the scan
    engine's dual evaluation (mbgps.py:173-195)."""
    lgc, _, _, diverged = gps_backward(augment_cost_kl(cost, ctl, alpha), dyn, alpha)
    xdist, udist, _ = gaussian_forward(dyn, lgc, mu0, sigma0)
    return policy_kl(lgc, ctl, xdist), diverged, lgc, xdist, udist


def _draw_kff(shape, generator, kw):
    """The initial kff = 1e-4·N(0, 1), drawn where ``generator`` lives."""
    where = generator.device if generator is not None else kw["device"]
    z = torch.randn(*shape, generator=generator, dtype=kw["dtype"], device=where)
    return 1e-4 * z.to(kw["device"])


def _initial_policy(T, dx, du, init_action_sigma, N, kff_init, generator, kw):
    if kff_init is None:
        kff_init = _draw_kff((N, T, du), generator, kw)
    sigma = init_action_sigma * torch.eye(du, **kw)
    return LinearGaussianPolicy(K=torch.zeros(N, T, du, dx, **kw), kff=kff_init,
                                sigma=sigma.expand(N, T, du, du))


def _adapt(state, expected_return, ret):
    """The adaptive bound multiplier (mbgps.py:276-292)."""
    expected_imp = state.last_return - expected_return
    actual_imp = state.last_return - ret
    mult = expected_imp / (2.0 * torch.clamp(expected_imp - actual_imp, min=1e-4))
    return torch.clamp(torch.clamp(mult, 0.1, 5.0) * state.kl_mult, 0.1, 5.0)


def make_mbgps_solver(
    env,
    nb_steps: int,
    nb_iter: int = 10,
    init_action_sigma: float = 1.0,
    kl_bound: float = 0.1,
    kl_adaptive: bool = False,
    kl_stepwise: bool = False,
    activation: dict | None = None,
    slew_rate: bool = False,
    action_penalty=None,
    bisect_iters: int = 64,
    differentiable: bool = False,
    time_mesh=None,
    *,
    device="cuda",
    dtype: torch.dtype = torch.float32,
):
    """Single-problem MBGPS: ``solve(mu0 (dx,), sigma0 (dx, dx), generator=None,
    kff_init=None) -> (state, trace (nb_iter+1,))``.

    ``trace`` holds the initial return and the accepted return after every
    iteration (held on rejected ones).  The initial kff is ``kff_init (T, du)``
    when given, else 1e-4·N(0, 1) drawn from ``generator``.  With
    ``kl_stepwise=True`` the dual is a vector over time, updated by
    ``log α_t += ½·log₁₀(KL_t / bound)`` (raised by 1 where the backward pass
    diverges), and acceptance needs every step within a quarter of the bound.
    The problem runs as a batch of one through the batched solver's scan
    engine.
    """
    if differentiable:
        raise NotImplementedError(
            "differentiable GPS solves are not ported yet (ROADMAP.md queue 1, row 15)"
        )
    if time_mesh is not None:
        raise _not_ported_mesh("horizon sharding (time_mesh)")
    batched = _make_solver(env, nb_steps, nb_iter, init_action_sigma, kl_bound, kl_adaptive,
                           kl_stepwise, activation, slew_rate, action_penalty, bisect_iters,
                           "scan", device, dtype)

    def solve(mu0: Tensor, sigma0: Tensor, generator: torch.Generator | None = None,
              kff_init: Tensor | None = None):
        state, traces = batched(mu0[None], sigma0[None], generator,
                                None if kff_init is None else kff_init[None])
        first = GPSState(*(type(f)(*(x[0] for x in f)) if isinstance(f, tuple) else f[0]
                           for f in state))
        return first, traces[0]

    return solve


def make_mbgps_solver_batched(
    env,
    nb_steps: int,
    nb_iter: int = 10,
    init_action_sigma: float = 1.0,
    kl_bound: float = 0.1,
    kl_adaptive: bool = False,
    activation: dict | None = None,
    slew_rate: bool = False,
    action_penalty=None,
    bisect_iters: int = 64,
    engine: str = "scan",
    *,
    device="cuda",
    dtype: torch.dtype = torch.float32,
):
    """Batch-native MBGPS: ``solve(mu0s (N, dx), sigma0s (N, dx, dx),
    generator=None, kff_init=None) -> (state, traces (N, nb_iter+1))``.

    The semantics of :func:`make_mbgps_solver` (scalar dual) for every
    instance, with the batch axis primal: the bisection runs each instance's
    bracket in lockstep and makes no host sync.  ``engine="cuda"`` packs the
    operands once per dual (``pack_gps``) and runs each bisection step as one
    launch of K6 and one of K7 for the whole batch, rewriting only the α
    plane; ``engine="scan"`` evaluates the scan chain.  Either way the
    controller at the found dual comes from the scan chain once per iteration,
    and its flag decides acceptance, as in the reference.  ``kff_init (N, T,
    du)`` replaces the draws from ``generator``.  ``solve.init(mu0s, sigma0s,
    generator, kff_init)`` gives the state before the first iteration and
    ``solve.iteration(state)`` runs one.
    """
    if engine not in ("scan", "cuda"):
        raise ValueError(f"unknown engine {engine!r}")
    return _make_solver(env, nb_steps, nb_iter, init_action_sigma, kl_bound, kl_adaptive,
                        False, activation, slew_rate, action_penalty, bisect_iters, engine,
                        device, dtype)


def _make_solver(env, nb_steps, nb_iter, init_action_sigma, kl_bound, kl_adaptive,
                 kl_stepwise, activation, slew_rate, action_penalty, bisect_iters, engine,
                 device, dtype):
    """The batched solver of both factories.  The dual ``log_alpha`` is (N, T)
    when stepwise and (N, 1) otherwise, so the KL it is held to is per step
    or summed over the horizon and acceptance is one ``all`` over the last
    axis either way; the stepwise dual runs on the scan engine only."""
    env, kw, weighting = _setup(env, nb_steps, activation, slew_rate, action_penalty,
                                device, dtype)
    T, dx, du = nb_steps, env.dm_state, env.dm_act

    def chain(state, log_alpha, mu0s, sigma0s):
        klt, diverged, lgc, xdist, udist = _dual_chain(
            state.cost, state.dyn, state.ctl, (10.0 ** log_alpha).expand(-1, T), mu0s, sigma0s)
        return (klt if kl_stepwise else klt.sum(-1, keepdim=True)), diverged, lgc, xdist, udist

    def bisect_dual(state, mu0s, sigma0s, bound):
        N = mu0s.shape[0]
        if kl_stepwise:
            la = torch.zeros(N, T, **kw)
            for _ in range(bisect_iters):
                kl, diverged, *_ = chain(state, la, mu0s, sigma0s)
                step = 0.5 * torch.log10(torch.clamp(kl, min=1e-14) / bound)
                la = torch.clamp(torch.where(diverged[:, None], la + 1.0, la + step),
                                 LOG_LO, LOG_HI)
            return la
        if engine == "cuda":
            packed = pack_gps(state.cost, state.dyn, state.ctl, mu0s, sigma0s)

            def kl_of(mid):
                alpha_l = pack_gps_alpha((10.0 ** mid).expand(N, T))
                K_l, kff_l, sigc_l, _, _, _, bad = cuda_gps_backward_packed(packed, alpha_l)
                kl_l, _, _ = cuda_gps_forward_kl_packed(packed, K_l, kff_l, sigc_l)
                return kl_l[0][:, None], bad
        else:
            def kl_of(mid):
                return chain(state, mid, mu0s, sigma0s)[:2]

        lo, hi = torch.full((N, 1), LOG_LO, **kw), torch.full((N, 1), LOG_HI, **kw)
        for _ in range(bisect_iters):
            mid = 0.5 * (lo + hi)
            kl, diverged = kl_of(mid)
            too_small = diverged[:, None] | (kl > bound)
            lo, hi = torch.where(too_small, mid, lo), torch.where(too_small, hi, mid)
        return 0.5 * (lo + hi)

    def iteration(state: GPSState) -> GPSState:
        mu0s, sigma0s = state.xdist.mu[:, 0], state.xdist.sigma[:, 0]
        bound = (kl_bound * state.kl_mult if kl_adaptive
                 else torch.full_like(state.last_return, kl_bound))[:, None]
        with record_function("gps.bisect"):
            log_alpha = bisect_dual(state, mu0s, sigma0s, bound)
        with record_function("gps.solution_at"):
            kl, diverged, lgc, xdist_lin, udist_lin = chain(state, log_alpha, mu0s, sigma0s)
            expected_return = evaluate_quadratic_cost(state.cost, xdist_lin.mu, udist_lin.mu)
            accept = ((kl - bound).abs() < 0.25 * bound).all(-1) & ~diverged
        with record_function("gps.propagate"):
            xdist_n, udist_n, lgd_n, ret = _propagate(env, weighting, lgc, mu0s, sigma0s)
        with record_function("gps.quadratize"):
            cost_n = quadratize_cost_abs(env.cost, xdist_n.mu, udist_n.mu, weighting)

        def sel(a, b):
            return type(a)(*(torch.where(_bcast(accept, x.dim()), x, y) for x, y in zip(a, b)))

        return GPSState(
            ctl=sel(lgc, state.ctl), xdist=sel(xdist_n, state.xdist),
            dyn=sel(lgd_n, state.dyn), cost=sel(cost_n, state.cost),
            last_return=torch.where(accept, ret, state.last_return),
            kl_mult=(torch.where(accept, _adapt(state, expected_return, ret), state.kl_mult)
                     if kl_adaptive else state.kl_mult),
            alpha=10.0 ** (log_alpha if kl_stepwise else log_alpha[:, 0]),
        )

    def init(mu0s: Tensor, sigma0s: Tensor, generator: torch.Generator | None = None,
             kff_init: Tensor | None = None) -> GPSState:
        """The state before the first iteration: the initial controller
        propagated and the cost quadratized along its mean."""
        _check_input(mu0s, kw)
        N = mu0s.shape[0]
        ctl0 = _initial_policy(T, dx, du, init_action_sigma, N, kff_init, generator, kw)
        xdist0, udist0, lgd0, ret0 = _propagate(env, weighting, ctl0, mu0s, sigma0s)
        return GPSState(
            ctl=ctl0, xdist=xdist0, dyn=lgd0,
            cost=quadratize_cost_abs(env.cost, xdist0.mu, udist0.mu, weighting),
            last_return=ret0, kl_mult=torch.ones(N, **kw),
            alpha=torch.full((N, T) if kl_stepwise else (N,), 1e8, **kw),
        )

    def solve(mu0s: Tensor, sigma0s: Tensor, generator: torch.Generator | None = None,
              kff_init: Tensor | None = None):
        state = init(mu0s, sigma0s, generator, kff_init)
        traces = [state.last_return]
        for _ in range(nb_iter):
            state = iteration(state)
            traces.append(state.last_return)
        return state, torch.stack(traces, dim=1)

    solve.init = init
    solve.iteration = iteration
    return solve


def make_gps_mpc_runner(
    env,
    horizon: int,
    nb_steps: int,
    nb_iter: int = 5,
    *,
    device="cuda",
    dtype: torch.dtype = torch.float32,
    **gps_kwargs,
):
    """Receding-horizon GPS-MPC (examples/gps/analytical/mpc/mb_pendulum.py):
    ``run(x0 (dx,), generator=None, kff_init=None, noise=None) -> (states
    (nb_steps+1, dx), actions (nb_steps, du), costs (nb_steps,))``.

    Each control step solves MBGPS from the current state with the env's
    initial covariance and applies the first mean action, clipped, to the
    noisy system.  ``kff_init (nb_steps, horizon, du)`` and ``noise (nb_steps,
    dx)`` replace the draws from ``generator``: each solve's initial kff and
    each step's additive process noise."""
    solve = make_mbgps_solver(env, horizon, nb_iter=nb_iter, device=device, dtype=dtype,
                              **gps_kwargs)
    kw = dict(dtype=dtype, device=_resolve(device))
    sigma0 = env.init()[1].to(**kw)
    ulim = env.ulim.to(**kw)
    one = torch.ones((), **kw)

    def run(x0: Tensor, generator: torch.Generator | None = None,
            kff_init: Tensor | None = None, noise: Tensor | None = None):
        x, xs, us, cs = x0, [], [], []
        for t in range(nb_steps):
            state, _ = solve(x, sigma0, generator, None if kff_init is None else kff_init[t])
            u = clip(state.ctl.kff[0] + _matvec(state.ctl.K[0], x), -ulim, ulim)
            cs.append(env.cost(x, u, u, one))
            xs.append(x)
            us.append(u)
            x = env.step(generator, x, u, None if noise is None else noise[t])
        return torch.stack(xs + [x]), torch.stack(us), torch.stack(cs)

    return run


def make_gps_mpc_runner_batched(
    env,
    horizon: int,
    nb_steps: int,
    nb_iter: int = 5,
    engine: str = "scan",
    *,
    device="cuda",
    dtype: torch.dtype = torch.float32,
    **gps_kwargs,
):
    """Batch-native GPS-MPC: ``run(x0s (N, dx), generator=None, kff_init=None,
    noise=None)`` solves every episode's MBGPS problem jointly at each control
    step with :func:`make_mbgps_solver_batched`, so each bisection step is one
    batched evaluation (two kernel launches with ``engine="cuda"``).
    ``kff_init (N, nb_steps, horizon, du)`` and ``noise (N, nb_steps, dx)``
    replace the draws from ``generator``.  Returns states ``(N, nb_steps+1,
    dx)``, actions ``(N, nb_steps, du)`` and costs ``(N, nb_steps)``."""
    solve = make_mbgps_solver_batched(env, horizon, nb_iter=nb_iter, engine=engine,
                                      device=device, dtype=dtype, **gps_kwargs)
    kw = dict(dtype=dtype, device=_resolve(device))
    sigma0 = env.init()[1].to(**kw)
    ulim = env.ulim.to(**kw)

    def run(x0s: Tensor, generator: torch.Generator | None = None,
            kff_init: Tensor | None = None, noise: Tensor | None = None):
        N = x0s.shape[0]
        sigma0s, ones = sigma0.expand(N, *sigma0.shape), torch.ones(N, **kw)
        x, xs, us, cs = x0s, [], [], []
        for t in range(nb_steps):
            state, _ = solve(x, sigma0s, generator,
                             None if kff_init is None else kff_init[:, t])
            u = clip(state.ctl.kff[:, 0] + _matvec(state.ctl.K[:, 0], x), -ulim, ulim)
            cs.append(env.cost(x, u, u, ones))
            xs.append(x)
            us.append(u)
            x = env.step(generator, x, u, None if noise is None else noise[:, t])
        return torch.stack(xs + [x], dim=1), torch.stack(us, dim=1), torch.stack(cs, dim=1)

    return run


def gps_mpc_draws(env, generator: torch.Generator | None, nb_episodes: int, horizon: int,
                  nb_steps: int, *, device="cuda", dtype: torch.dtype = torch.float32):
    """The draws of :func:`run_gps_mpc_batch`, in its order: the initial
    states ``(nb_episodes, dx)`` from ``env.sample_init``, every solve's
    initial kff ``(nb_episodes, nb_steps, horizon, du)``, every step's process
    noise ``(nb_episodes, nb_steps, dx)``."""
    kw = dict(dtype=dtype, device=_resolve(device))
    x0s = torch.stack([env.sample_init(generator, **kw) for _ in range(nb_episodes)])
    kff_init = _draw_kff((nb_episodes, nb_steps, horizon, env.dm_act), generator, kw)
    zero = torch.zeros(nb_episodes, nb_steps, env.dm_state, **kw)
    return x0s, kff_init, gaussian(zero, env.noise_factor(dtype, zero.device), generator)


def run_gps_mpc_batch(
    env,
    generator: torch.Generator | None,
    nb_episodes: int,
    horizon: int,
    nb_steps: int,
    nb_iter: int = 5,
    mesh=None,
    batched: bool = False,
    engine: str = "scan",
    *,
    device="cuda",
    dtype: torch.dtype = torch.float32,
    **gps_kwargs,
):
    """A batch of GPS-MPC episodes from initial states drawn with
    ``env.sample_init`` (the replacement for the reference's 50-job joblib farm,
    examples/gps/analytical/mpc/mb_pendulum_parallel.py).  ``batched=False``
    runs :func:`make_gps_mpc_runner` on each episode in turn; ``batched=True``
    runs :func:`make_gps_mpc_runner_batched` on all of them at once.  All
    draws are made up front by :func:`gps_mpc_draws`, so both modes see the
    same ones.  Returns ``{"x": states, "u": actions, "c": costs}``,
    episode-leading."""
    if mesh is not None:
        raise _not_ported_mesh("sharding the episodes over a mesh")
    kw = dict(dtype=dtype, device=_resolve(device))
    x0s, kff_init, noise = gps_mpc_draws(env, generator, nb_episodes, horizon, nb_steps, **kw)
    if batched:
        run = make_gps_mpc_runner_batched(env, horizon, nb_steps, nb_iter=nb_iter,
                                          engine=engine, **kw, **gps_kwargs)
        states, actions, costs = run(x0s, kff_init=kff_init, noise=noise)
    else:
        # as in the reference, ``engine`` names a batched engine and reaches
        # only the batched runner
        run_one = make_gps_mpc_runner(env, horizon, nb_steps, nb_iter=nb_iter, **kw,
                                      **gps_kwargs)
        outs = [run_one(x0s[i], kff_init=kff_init[i], noise=noise[i])
                for i in range(nb_episodes)]
        states, actions, costs = (torch.stack(f) for f in zip(*outs))
    return {"x": states, "u": actions, "c": costs}
