"""Belief-space iLQR and belief-MPC (counterpart of ``trajopt_tpu/parallel/bsp.py``).

One iteration: expand the belief dynamics (the Jacobian of the EKF step) and
the belief cost along the reference, run the λ-escalated (S, s, τ) backward
pass, roll the belief out along the 11-point α grid, and accept the first
α that improves on the expected reduction (bspilqr/bspilqr.py:126-224).

* :func:`make_bsp_solver` solves one problem with the dense value form and
  the scan backward (``core/belief.bsp_backward``); it runs as a batch of one
  through the batched solver.
* :func:`make_bsp_solver_batched` solves a batch with per-instance masked λ
  escalation around one batched backward per trial: ``engine="scan"`` runs
  the scan recursion over the batch, ``engine="cuda"`` packs the expansion
  once per iteration and launches kernel K8 (``core/cuda_belief``) per trial.
* :func:`make_bsp_mpc_runner` drives EKF-in-the-loop belief-MPC: per control
  step a replan from the current belief, the first action on the noisy true
  system and an EKF update.  ``engine="scan"`` replans with
  :func:`make_bsp_solver`; ``engine="cuda"`` runs the whole episode as one
  launch of kernel K10 (``core/cuda_bsp``), whose replan is kernel K9's solve.
  :func:`run_bsp_mpc_batch` runs a batch of episodes.

The standard normals of an episode (the first observation's, then each
step's process and observation noise) come from a ``torch.Generator`` or are
handed in; every draw is ``mean + chol(cov) ε``.  On CPU tensors the kernel
wrappers run their plain versions.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch import Tensor

from ..core.belief import belief_cost_expansion, belief_dynamics_expansion, bsp_backward
from ..core.cuda_belief import cuda_bsp_backward_packed, pack_belief
from ..core.cuda_bsp import NL, make_cuda_bsp_episode
from ..core.cuda_lqr import from_soa
from ..core.ekf import EKF, belief_ekf_step
from ..envs.base import _matvec, chol_draw, standard_normal
from ..solvers.common import DEFAULT_ALPHAS
from .mpc import _bcast, _not_ported_mesh, _resolve


class BSPState(NamedTuple):
    """Solver state: unbatched from :func:`make_bsp_solver`, batch-leading
    from :func:`make_bsp_solver_batched`."""

    bref_mu: Tensor      # (T+1, b)
    bref_sigma: Tensor   # (T+1, b, b)
    uref: Tensor         # (T, a)
    K: Tensor            # (T, a, b)
    kff: Tensor          # (T, a)
    lmbda: Tensor        # ()
    dlmbda: Tensor       # ()
    last_return: Tensor  # ()
    done: Tensor         # () bool


def _not_ported(what: str, row: str):
    return NotImplementedError(f"{what} is not ported yet (ROADMAP.md queue 1, row {row})")


def make_bsp_solver(
    env,
    nb_steps: int,
    nb_iter: int = 25,
    alphas=DEFAULT_ALPHAS,
    lmbda: float = 1.0,
    min_lmbda: float = 1e-6,
    max_lmbda: float = 1e6,
    mult_lmbda: float = 1.6,
    tolfun: float = 1e-8,
    tolgrad: float = 1e-6,
    min_imp: float = 0.0,
    reg: int = 1,
    value_form: str = "dense",
    backward: str = "scan",
    time_mesh=None,
    differentiable: bool = False,
    *,
    device="cuda",
    dtype: torch.dtype = torch.float32,
):
    """Single-problem BSP-iLQR: ``solve(mu0 (b,), sigma0 (b, b), kff_init
    (T, a) | None) -> (state, trace (nb_iter,))``, the outer loop of
    bspilqr/bspilqr.py:126-224 with its λ/α/termination semantics.

    Semantics kept: the initial trajectory is the first α candidate whose
    belief means stay below 1e8; the λ while-loop runs trials from the state's
    λ until one succeeds or λ passes ``max_lmbda`` (a λ already above it runs
    one trial and counts as not diverged); an α is acceptable when its
    improvement ratio exceeds ``min_imp``; λ is zeroed below ``min_lmbda``; no
    work once the solve is done.  ``trace`` holds the accepted return after
    every iteration.  The λ loop's condition syncs with the host once per
    trial.
    """
    if time_mesh is not None:
        raise _not_ported_mesh("horizon sharding (time_mesh)")
    if differentiable:
        raise _not_ported("differentiable BSP solves", "15")
    if backward == "pscan":
        raise _not_ported("backward='pscan' (the parallel-in-time belief backward)", "11c")
    if backward != "scan":
        raise ValueError(f"unknown backward impl {backward!r}")
    if value_form == "sqrt":
        raise _not_ported("value_form='sqrt' (bsp_backward_sqrt)", "11b")
    if value_form != "dense":
        raise ValueError(f"unknown value_form {value_form!r}")
    batched = _make_solver(env, nb_steps, nb_iter, alphas, lmbda, min_lmbda, max_lmbda,
                           mult_lmbda, tolfun, tolgrad, min_imp, reg, "scan", True, device,
                           dtype)

    def solve(mu0: Tensor, sigma0: Tensor, kff_init: Tensor | None = None):
        state, trace = batched(mu0[None], sigma0[None],
                               None if kff_init is None else kff_init[None])
        return BSPState(*(x[0] for x in state)), trace[:, 0]

    return solve


def make_bsp_solver_batched(
    env,
    nb_steps: int,
    nb_iter: int = 25,
    alphas=DEFAULT_ALPHAS,
    lmbda: float = 1.0,
    min_lmbda: float = 1e-6,
    max_lmbda: float = 1e6,
    mult_lmbda: float = 1.6,
    tolfun: float = 1e-8,
    tolgrad: float = 1e-6,
    min_imp: float = 0.0,
    reg: int = 1,
    engine: str = "scan",
    mesh=None,
    *,
    device="cuda",
    dtype: torch.dtype = torch.float32,
):
    """Batch-of-problems BSP-iLQR: ``solve(mu0s (N, b), sigma0s (N, b, b),
    kff_inits (N, T, a) | None) -> (state, trace (nb_iter, N))`` with the
    per-instance semantics of :func:`make_bsp_solver` (dense value form).

    The λ loop carries per-instance (λ, Δλ, diverged): the first trial runs at
    every instance's λ, then the loop runs while any instance that is not
    done diverged with λ ≤ ``max_lmbda``, and an instance whose trial
    succeeded keeps its result.  ``engine="cuda"`` runs each trial's backward
    for the whole batch as one launch of K8; ``"scan"`` runs the scan
    recursion over the batch.  ``solve.init(mu0s, sigma0s, kff_inits)`` gives
    the state before the first iteration and ``solve.iteration(state)`` runs
    one; ``solve.trials`` counts the λ trials run so far (one backward each).
    """
    if mesh is not None:
        raise _not_ported_mesh("sharding the problems over a mesh")
    if engine not in ("scan", "cuda"):
        raise ValueError(f"unknown engine {engine!r}")
    return _make_solver(env, nb_steps, nb_iter, alphas, lmbda, min_lmbda, max_lmbda,
                        mult_lmbda, tolfun, tolgrad, min_imp, reg, engine, False, device,
                        dtype)


def _make_solver(env, nb_steps, nb_iter, alphas, lmbda, min_lmbda, max_lmbda, mult_lmbda,
                 tolfun, tolgrad, min_imp, reg, engine, single, device, dtype):
    """The batched solver of both factories and of K9's plain version.

    ``engine`` is ``"scan"`` or ``"cuda"`` (the λ while-loop around one
    backward per trial) or ``"ladder"``: every trial of the λ ladder run at
    once as a batch axis, then the trial the while-loop would stop at taken,
    as kernel K9 does.  ``single`` keeps the single-problem loop's rule for a
    λ above ``max_lmbda`` at the start of an iteration: one trial, counted as
    not diverged."""
    if reg not in (1, 2):
        raise ValueError(f"reg must be 1 or 2, got {reg}")
    T = nb_steps
    b, a = env.belief_dim, env.act_dim
    device = _resolve(device)
    kw = dict(dtype=dtype, device=device)
    alphas = torch.tensor(tuple(float(x) for x in alphas), **kw)
    nA = alphas.shape[0]

    def escalate(div, lam, dlam):
        dlam = torch.where(div, (dlam * mult_lmbda).clamp(min=mult_lmbda), dlam)
        return torch.where(div, (lam * dlam).clamp(min=min_lmbda), lam), dlam

    def forward_all(K, kff, mu0, sigma0, bref_mu, uref):
        """Belief rollouts of every α for every instance: (N, nA, ...)."""
        N = mu0.shape[0]
        al = alphas[:, None]
        mu = mu0[:, None].expand(N, nA, b)
        sigma = sigma0[:, None].expand(N, nA, b, b)
        mus, sigmas, us, cs = [], [], [], []
        for t in range(T):
            u = (uref[:, None, t] + al * kff[:, None, t]
                 + _matvec(K[:, None, t], mu - bref_mu[:, None, t]))
            cs.append(env.cost(mu, sigma, u))
            mus.append(mu)
            sigmas.append(sigma)
            us.append(u)
            mu, _, sigma = belief_ekf_step(env, mu, sigma, u)
        cs.append(env.cost(mu, sigma, torch.zeros_like(us[-1])))
        return (torch.stack(mus + [mu], dim=2), torch.stack(sigmas + [sigma], dim=2),
                torch.stack(us, dim=2), torch.stack(cs, dim=2))

    def expand(state):
        dyn = belief_dynamics_expansion(env, state.bref_mu[:, :T], state.bref_sigma[:, :T],
                                        state.uref)
        return belief_cost_expansion(env, state.bref_mu, state.bref_sigma, state.uref), dyn

    def backward_with_lm(cost, dyn, state):
        """(K, kff, dS (N, 2), λ, Δλ, diverged) after λ escalation."""
        if engine == "ladder":
            return _ladder(cost, dyn, state.lmbda, state.dlmbda)
        if engine == "cuda":
            packed = pack_belief(cost, dyn)

            def bw(lam):
                out = cuda_bsp_backward_packed(packed, lam, reg)
                return (out[0], out[1], out[5]), out[6]

            def select(m, new, old):
                return torch.where(m, new, old)
        else:
            def bw(lam):
                pol, _, _, _, dS, div = bsp_backward(cost, dyn, lam, reg)
                return (pol.K, pol.kff, dS), div

            def select(m, new, old):
                return torch.where(_bcast(m, new.dim()), new, old)

        def trial(lam):
            solve.trials += 1
            return bw(lam)

        out, div = trial(state.lmbda)
        div = div & ~state.done
        if single:
            div = div & (state.lmbda <= max_lmbda)
        lam, dlam = escalate(div, state.lmbda, state.dlmbda)
        while True:
            active = div & (lam <= max_lmbda)
            if not bool(active.any()):
                break
            new, new_div = trial(lam)
            out = tuple(select(active, n, o) for n, o in zip(new, out))
            div = torch.where(active, new_div, div)
            lam, dlam = escalate(active & new_div, lam, dlam)
        K, kff, dS = out
        if engine == "cuda":
            N = K.shape[-1]
            K, kff, dS = from_soa(K, N, (a, b)), from_soa(kff, N, (a,)), dS.T
        return K, kff, dS, lam, dlam, div

    def _ladder(cost, dyn, lam0, dlam0):
        lams, dls = [lam0], [dlam0]
        for _ in range(NL):
            dln = (dls[-1] * mult_lmbda).clamp(min=mult_lmbda)
            lams.append((lams[-1] * dln).clamp(min=min_lmbda))
            dls.append(dln)
        lams, dls = torch.stack(lams, dim=1), torch.stack(dls, dim=1)    # (N, NL + 1)
        N = lam0.shape[0]

        def trials(x):
            return x.unsqueeze(1).expand(N, NL, *x.shape[1:])

        pol, _, _, _, dS, bad = bsp_backward(type(cost)(*map(trials, cost)),
                                             type(dyn)(*map(trials, dyn)), lams[:, :NL], reg)
        # the while-loop stops at the first trial that succeeds or whose next
        # λ passes the bound (always within the ladder for the default
        # schedule; beyond it the last trial is taken)
        stop = ~bad | (lams[:, 1:] > max_lmbda)
        idx = torch.where(stop.any(1), stop.to(torch.uint8).argmax(1), NL - 1)
        rows = torch.arange(N, device=lam0.device)
        lam_sel = lams[rows, idx]
        div = bad[rows, idx] & (lam_sel <= max_lmbda)
        return (pol.K[rows, idx], pol.kff[rows, idx], dS[rows, idx],
                torch.where(div, lams[rows, idx + 1], lam_sel),
                torch.where(div, dls[rows, idx + 1], dls[rows, idx]), div)

    def iteration(state: BSPState):
        cost, dyn = expand(state)
        K, kff, dS, lam, dlam, div = backward_with_lm(cost, dyn, state)
        N = lam.shape[0]
        rows = torch.arange(N, device=device)
        g_norm = (kff.abs() / (state.uref.abs() + 1.0)).amax(dim=1).mean(dim=-1)
        grad_done = (g_norm < tolgrad) & (lam < 1e-5)

        mus, sigmas, us, cs = forward_all(K, kff, state.bref_mu[:, 0], state.bref_sigma[:, 0],
                                          state.bref_mu, state.uref)
        returns = cs.sum(dim=-1)                                       # (N, nA)
        dreturns = state.last_return[:, None] - returns
        expected = -1.0 * alphas * (dS[:, :1] + alphas * dS[:, 1:])
        imp = dreturns / expected                                      # IEEE x/0
        ok = (imp > min_imp) & ~div[:, None] & torch.isfinite(returns)
        accepted = ok.any(dim=1)
        idx = ok.to(torch.uint8).argmax(dim=1)                         # first acceptable α

        dlam_acc = (dlam / mult_lmbda).clamp(max=1.0 / mult_lmbda)
        lam_acc = lam * dlam_acc * (lam > min_lmbda)
        dlam_rej = (dlam * mult_lmbda).clamp(min=mult_lmbda)
        lam_rej = (lam * dlam_rej).clamp(min=min_lmbda)

        take = accepted & ~grad_done

        def sel(new, old):
            return torch.where(_bcast(take, new.dim()), new, old)

        new = BSPState(
            bref_mu=sel(mus[rows, idx], state.bref_mu),
            bref_sigma=sel(sigmas[rows, idx], state.bref_sigma),
            uref=sel(us[rows, idx], state.uref),
            K=sel(K, state.K), kff=sel(kff, state.kff),
            lmbda=sel(lam_acc, lam_rej), dlmbda=sel(dlam_acc, dlam_rej),
            last_return=sel(returns[rows, idx], state.last_return),
            done=(grad_done | (take & (dreturns[rows, idx] < tolfun))
                  | (~accepted & (lam_rej > max_lmbda))),
        )
        # finished instances keep their state
        return BSPState(*(torch.where(_bcast(state.done, o.dim()), o, n)
                          for o, n in zip(state, new)))

    def init(mu0s: Tensor, sigma0s: Tensor, kff_inits: Tensor | None = None) -> BSPState:
        """The state before the first iteration: the first α candidate, rolled
        out from zero gains and ``kff_inits``, whose means stay below 1e8."""
        if mu0s.device != device or mu0s.dtype != dtype:
            raise ValueError(f"mu0s is {mu0s.dtype} on {mu0s.device}; this solver was "
                             f"built for {dtype} on {device}")
        N = mu0s.shape[0]
        kff0 = torch.zeros(N, T, a, **kw) if kff_inits is None else kff_inits
        K0 = torch.zeros(N, T, a, b, **kw)
        bref_mu0 = torch.zeros(N, T + 1, b, **kw)
        bref_mu0[:, 0] = mu0s
        mus, sigmas, us, cs = forward_all(K0, kff0, mu0s, sigma0s, bref_mu0,
                                          torch.zeros(N, T, a, **kw))
        idx = (mus < 1e8).all(dim=3).all(dim=2).to(torch.uint8).argmax(dim=1)
        rows = torch.arange(N, device=device)
        return BSPState(
            bref_mu=mus[rows, idx], bref_sigma=sigmas[rows, idx], uref=us[rows, idx],
            K=K0, kff=kff0, lmbda=torch.full((N,), lmbda, **kw), dlmbda=torch.ones(N, **kw),
            last_return=cs[rows, idx].sum(dim=-1),
            done=torch.zeros(N, dtype=torch.bool, device=device),
        )

    def solve(mu0s: Tensor, sigma0s: Tensor, kff_inits: Tensor | None = None):
        state = init(mu0s, sigma0s, kff_inits)
        trace = []
        for _ in range(nb_iter):
            # an iteration leaves finished instances as they are
            if not bool(state.done.all()):
                state = iteration(state)
            trace.append(state.last_return)
        return state, torch.stack(trace)

    solve.init = init
    solve.iteration = iteration
    solve.trials = 0
    return solve


def bsp_episode_normals(env, generator: torch.Generator | None, nb_steps: int, *,
                        device="cuda", dtype: torch.dtype = torch.float32):
    """The standard normals of one belief-MPC episode, in the order they are
    drawn: the first observation's ``(do,)``, then every step's process noise
    ``(nb_steps, dx)`` and observation noise ``(nb_steps, do)``."""
    device = _resolve(device)
    return (standard_normal((env.obs_dim,), generator, dtype, device),
            standard_normal((nb_steps, env.state_dim), generator, dtype, device),
            standard_normal((nb_steps, env.obs_dim), generator, dtype, device))


def run_bsp_episode(env, solve, x0: Tensor, normals) -> tuple[Tensor, ...]:
    """The EKF-in-the-loop episode (examples/bspilqr/lightdark.py:24-45) with
    ``solve(mu, sigma) -> (state, trace)`` as the replan: innovate the initial
    belief on a first observation; then at every step replan, apply the first
    action to the true system, observe, and update the belief.  Returns
    (states, belief means, belief covariances, actions, belief costs)."""
    eps0, eps_dyn, eps_obs = normals
    filt = EKF(env)
    mu0, sigma0 = (v.to(dtype=x0.dtype, device=x0.device) for v in env.init())
    mu_b, cov_b = filt.innovate(mu0, sigma0, chol_draw(env.observe(x0), env.obs_noise(x0), eps0))
    x, xs, mus, sigmas, us, cs = x0, [], [], [], [], []
    for s in range(eps_dyn.shape[0]):
        state, _ = solve(mu_b, cov_b)
        u = state.uref[0]
        cs.append(env.cost(mu_b, cov_b, u))
        xs.append(x)
        mus.append(mu_b)
        sigmas.append(cov_b)
        us.append(u)
        x, obs = env.step(None, x, u, (eps_dyn[s], eps_obs[s]))
        mu_b, cov_b = filt.inference(mu_b, cov_b, u, obs)
    return (torch.stack(xs + [x]), torch.stack(mus + [mu_b]), torch.stack(sigmas + [cov_b]),
            torch.stack(us), torch.stack(cs))


def make_bsp_mpc_runner(
    env,
    horizon: int,
    nb_steps: int,
    nb_iter: int = 25,
    belief_filter: str = "joseph",
    engine: str = "auto",
    *,
    device="cuda",
    dtype: torch.dtype = torch.float32,
    **bsp_kwargs,
):
    """EKF-in-the-loop belief-MPC (examples/bspilqr/lightdark.py:24-45):
    ``run(x0 (dx,), generator=None, normals=None) -> (states (nb_steps+1, dx),
    belief means (nb_steps+1, b), belief covariances (nb_steps+1, b, b),
    actions (nb_steps, a), belief costs (nb_steps,))``.

    The episode innovates the initial belief on a first observation, then at
    every control step replans BSP-iLQR (``horizon`` steps, ``nb_iter``
    iterations) from the current belief, applies the first planned action to
    the noisy true system and folds the new observation in with a Joseph-form
    EKF update.  The standard normals come from ``generator`` or are handed in
    as ``normals`` (see :func:`bsp_episode_normals`).

    ``engine="scan"`` replans with :func:`make_bsp_solver`; ``"cuda"`` runs
    the whole episode as one launch of kernel K10; ``"auto"`` picks ``"cuda"``
    when the device is a CUDA device, the env has the kernels' device
    functions (``supports_belief_tiles``), the filter is Joseph, the value
    form dense and the solve not differentiable, else ``"scan"``.
    ``run.engine`` names the engine chosen.
    """
    if belief_filter == "sqrt":
        raise _not_ported("belief_filter='sqrt' (core/sqrt_ekf.py)", "11a")
    if belief_filter != "joseph":
        raise ValueError(f"unknown belief_filter {belief_filter!r}")
    device = _resolve(device)
    if engine == "auto":
        cuda_ok = (device.type == "cuda" and env.supports_belief_tiles
                   and bsp_kwargs.get("value_form", "dense") == "dense"
                   and not bsp_kwargs.get("differentiable", False))
        engine = "cuda" if cuda_ok else "scan"
    kw = dict(device=device, dtype=dtype)
    if engine == "cuda":
        if bsp_kwargs.pop("value_form", "dense") != "dense" or bsp_kwargs.pop(
                "differentiable", False):
            raise ValueError("engine='cuda' solves the dense value form, not differentiable")
        episode = make_cuda_bsp_episode(env, horizon, nb_steps, nb_iter=nb_iter, **bsp_kwargs)
    elif engine == "scan":
        solve = make_bsp_solver(env, horizon, nb_iter=nb_iter, **kw, **bsp_kwargs)
    else:
        raise ValueError(f"unknown engine {engine!r}")

    def run(x0: Tensor, generator: torch.Generator | None = None, normals=None):
        if x0.device != device or x0.dtype != dtype:
            raise ValueError(f"x0 is {x0.dtype} on {x0.device}; this runner was built for "
                             f"{dtype} on {device}")
        if normals is None:
            normals = bsp_episode_normals(env, generator, nb_steps, **kw)
        if engine == "cuda":
            return episode(x0, *normals)
        return run_bsp_episode(env, solve, x0, normals)

    run.engine = engine
    return run


def run_bsp_mpc_batch(
    env,
    generator: torch.Generator | None,
    nb_episodes: int,
    horizon: int,
    nb_steps: int,
    nb_iter: int = 25,
    mesh=None,
    *,
    device="cuda",
    dtype: torch.dtype = torch.float32,
    **bsp_kwargs,
):
    """A batch of belief-MPC episodes from the env's reset state, each on
    normals of its own, all drawn from ``generator`` before the episodes run
    (episode by episode, in the order of :func:`bsp_episode_normals`).  The
    episodes run one after the other on the scan runner unless ``engine`` is
    given.  Returns ``{"x", "mu", "sigma", "u", "c"}``, episode-leading."""
    if mesh is not None:
        raise _not_ported_mesh("sharding the episodes over a mesh")
    bsp_kwargs.setdefault("engine", "scan")
    kw = dict(device=_resolve(device), dtype=dtype)
    run = make_bsp_mpc_runner(env, horizon, nb_steps, nb_iter=nb_iter, **kw, **bsp_kwargs)
    draws = [bsp_episode_normals(env, generator, nb_steps, **kw) for _ in range(nb_episodes)]
    x0 = env.reset_state().to(**kw)
    outs = [run(x0, normals=n) for n in draws]
    return dict(zip(("x", "mu", "sigma", "u", "c"), (torch.stack(f) for f in zip(*outs))))
