"""Compiled distributionally-robust GPS, variants ``lr`` and ``mb``
(counterpart of ``trajopt_tpu/parallel/rgps.py``).

One outer iteration alternates the two players of the min-max:

* **adversary** — the geometric β-bisection of the reference
  (mbrgps.py:419-451) over the dual of the KL-to-nominal bound: each
  evaluation runs the damped fixed point (parameter backward pass ∘ cubature
  forward pass, q ← interp(q, p; 0.1)) and a diverged or non-finite
  evaluation means "β too small".  ``beta_search="parallel"`` evaluates
  ``beta_grid`` candidates per round in one batched fixed point instead;
  ``iterative_adversary=True`` runs the regularized adversary
  (mbrgps.py:633-676) as masked η-bisections.
* **policy** — the soft-KL controller under the adversary's parameters, its
  dual found by a log-α bisection (or ``alpha_search="parallel"`` grid
  rounds, or the damped per-step fixed point of ``policy_kl_stepwise``);
  accepted if the KL stays under 1.25·bound.
* ``lr`` scores an iterate by the exact quadratic expectation and keeps the
  env's analytic linearization as the nominal; ``mb`` relinearizes the
  nominal along the EKF mean (``core/ekf``) and scores by the mean path's cost.

The solver is batched over a leading instance axis and every scalar decision
of the JAX solver is a per-instance mask, so a batch computes what
``jax.vmap(solve)`` computes.  The fixed point runs on ``fp_engine="cuda"``
(kernels K15/K16 of ``core/cuda_rgps``; their plain versions on CPU tensors)
or ``"scan"`` (``core/cubature``); ``"auto"`` takes ``cuda`` on a CUDA device.
Every fixed point ends by a host test of ``any(active)`` per trip.  The
β-bisection is a fixed number of steps in the reference; this port stops
evaluating once every instance is done, after which no output moves.

``variant="mf"``, ``differentiable=True`` and a mesh raise (ROADMAP.md queue
1, rows 13, 15 and 17).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
from torch import Tensor
from torch.profiler import record_function

from ..core.cubature import (
    cubature_forward_pass,
    parameter_augment_cost,
    parameter_backward_pass,
    policy_backward_pass,
)
from ..core.cuda_rgps import cuda_rgps_fixed_point, fixed_point_loop
from ..core.diff import evaluate_quadratic_cost, quadratize_cost_abs
from ..core.scan_lqr import (
    augment_cost_kl,
    gaussian_interp_kl,
    gaussian_interp_w2,
    gaussian_kl,
    policy_kl,
)
from ..core.types import (
    GaussianSequence,
    LinearGaussianPolicy,
    MatrixNormalParams,
    QuadraticCost,
    vec_from_matrices,
)
from ..envs.base import standard_normal
from ..solvers.common import make_weighting
from .gps import _check_input, _propagate
from .mpc import _bcast, _not_ported_mesh, _resolve

LOG_LO, LOG_HI = -16.0, 16.0
FP_TOL = 1e-3


class RGPSState(NamedTuple):
    """Solver state: unbatched from :func:`make_rgps_solver`, instance-leading
    from :func:`make_rgps_solver_batched`.  (The JAX state's PRNG key serves
    only ``mf`` and has no counterpart here.)"""

    ctl: LinearGaussianPolicy        # (T, …)
    xdist: GaussianSequence          # (T+1, …)
    udist: GaussianSequence          # (T, …)
    cost: QuadraticCost              # (T+1, …), absolute convention
    nominal: MatrixNormalParams      # (T, …)
    noise: Tensor                    # (T, dx, dx)
    last_return: Tensor              # ()
    beta: Tensor                     # () last adversary dual
    alpha: Tensor                    # () last policy dual ((T,) when stepwise)


def _select(mask: Tensor, new, old):
    """Per-instance select over a container (or tensor) with the instance
    axis first."""
    if isinstance(new, Tensor):
        return torch.where(_bcast(mask, new.dim()), new, old)
    return type(new)(*(_select(mask, a, b) for a, b in zip(new, old)))


def _rows(x, G: int):
    """Repeat each instance's entry ``G`` times (instance-major rows)."""
    if isinstance(x, Tensor):
        return x.repeat_interleave(G, dim=0)
    return type(x)(*(_rows(a, G) for a in x))


def _big(dtype: torch.dtype) -> float:
    """The upper β bracket: the reference's 1e64 (mbrgps.py:423) where the
    dtype holds it, else 1e30, whose products with 1e-4 stay finite."""
    return 1e64 if float(torch.finfo(dtype).max) > 1e65 else 1e30


def make_rgps_solver(env, nb_steps: int, variant: str = "lr", nb_iter: int = 10, *,
                     device="cuda", dtype: torch.dtype = torch.float32, **kwargs):
    """Single-problem robust GPS: ``solve(mu0 (dx,), sigma0 (dx, dx)) ->
    (state, trace (nb_iter+1,))``, a batch of one through
    :func:`make_rgps_solver_batched` (whose keywords it takes).
    ``solve.iteration(state)`` runs one iteration on the unbatched state;
    ``solve.batched`` is the batched solver."""
    batched = make_rgps_solver_batched(env, nb_steps, variant, nb_iter, device=device,
                                       dtype=dtype, **kwargs)

    def solve(mu0: Tensor, sigma0: Tensor):
        state, traces = batched(mu0[None], sigma0[None])
        return _map(lambda x: x[0], state), traces[0]

    solve.iteration = lambda state: _map(lambda x: x[0],
                                         batched.iteration(_map(lambda x: x[None], state)))
    solve.batched = batched
    return solve


def _map(fn, state: RGPSState) -> RGPSState:
    return RGPSState(*(fn(f) if isinstance(f, Tensor) else type(f)(*(fn(x) for x in f))
                       for f in state))


def make_rgps_solver_batched(
    env,
    nb_steps: int,
    variant: str = "lr",
    nb_iter: int = 10,
    init_action_sigma: float = 1.0,
    policy_kl_bound: float = 0.1,
    policy_kl_stepwise: bool = False,
    param_nominal_kl_bound: float = 100.0,
    nominal_variance: float = 1e-8,
    activation: dict | None = None,
    slew_rate: bool = False,
    action_penalty=None,
    optimize_adversary: bool = True,
    iterative_adversary: bool = False,
    param_regularizer_kl_bound: float = 1.0,
    beta_iters: int = 50,
    beta_search: str = "bisect",
    beta_rounds: int = 3,
    beta_grid: int = 16,
    eta_iters: int = 10,
    reg_steps: int = 20,
    alpha_bisect_iters: int = 64,
    alpha_search: str = "bisect",
    alpha_rounds: int = 5,
    alpha_grid: int = 16,
    fp_iters: int = 100,
    fp_engine: str = "auto",
    interp: str = "kl",
    differentiable: bool = False,
    *,
    device="cuda",
    dtype: torch.dtype = torch.float32,
):
    """Batched robust GPS: ``solve(mu0s (N, dx), sigma0s (N, dx, dx)) ->
    (state, traces (N, nb_iter+1))``, each instance solved as the JAX solver
    solves it (``make_rgps_solver``'s options and defaults).

    ``trace`` holds the initial return and the accepted return after each
    iteration.  ``solve.init(mu0s, sigma0s)`` gives the state before the
    first iteration and ``solve.iteration(state)`` runs one;
    ``solve.fixed_points`` counts the fixed points run (each ends with one
    host sync more than its trips), ``solve.fp_engine`` is the engine used.
    """
    if variant == "mf":
        raise NotImplementedError(
            "variant='mf' needs parallel/regression and solvers/common.rollout_batch, not "
            "ported yet (ROADMAP.md queue 1, row 13, its later part)")
    if variant not in ("lr", "mb"):
        raise ValueError(f"unknown variant {variant!r}")
    if differentiable:
        raise NotImplementedError(
            "differentiable robust GPS solves are not ported yet (ROADMAP.md queue 1, row 15)")
    if fp_engine not in ("scan", "cuda", "auto"):
        raise ValueError(f"unknown fp_engine {fp_engine!r}")
    if interp not in ("kl", "w2"):
        raise ValueError(f"unknown interp {interp!r} (options: 'kl', 'w2')")
    if beta_search not in ("bisect", "parallel"):
        raise ValueError(f"unknown beta_search {beta_search!r}")
    if alpha_search not in ("bisect", "parallel"):
        raise ValueError(f"unknown alpha_search {alpha_search!r}")
    device = _resolve(device)
    if interp == "w2":
        if fp_engine == "cuda":
            raise ValueError("fp_engine='cuda' implements the KL damping geodesic in-kernel; "
                             "use fp_engine='scan' with interp='w2'")
        fp_engine = "scan"       # the W2 geodesic needs eigh, not in the kernel
    if fp_engine == "auto":
        fp_engine = "cuda" if device.type == "cuda" else "scan"

    overrides = {"slew_rate": slew_rate}
    if action_penalty is not None:
        overrides["uw"] = tuple(float(action_penalty) for _ in range(env.dm_act))
    env = env.replace(**overrides)
    kw = dict(dtype=dtype, device=device)
    T, dx, du = nb_steps, env.dm_state, env.dm_act
    p = dx * (dx + du + 1)
    weighting = make_weighting(nb_steps, activation, **kw)
    noise_fixed = env.sigma.to(**kw).expand(T, dx, dx)
    big = _big(dtype)
    damp = gaussian_interp_w2 if interp == "w2" else gaussian_interp_kl

    def quadratize(xmu, umu):
        return quadratize_cost_abs(env.cost, xmu, umu, weighting)

    def cubature(ctl, param, mu0, sigma0, noise):
        return cubature_forward_pass(mu0, sigma0, param, noise, ctl)

    # ------------------------------------------------------------- adversary side
    def fixed_point(agCpp, agcp, ctl, cost, xdist0, beta, mu0, sigma0, noise, group):
        """The damped fixed point (mbrgps.py:386-408) over rows; ``group``
        consecutive rows are one instance's β-candidates."""
        solve.fixed_points += 1
        if fp_engine == "cuda":
            _, param, diverged = cuda_rgps_fixed_point(
                agCpp, agcp, ctl, cost, xdist0, beta, mu0, sigma0, noise, tol=FP_TOL,
                fp_iters=fp_iters, group=group)
            return param, diverged

        def trip(q):
            param, _, diverged = parameter_backward_pass(q, ctl, noise, cost, agCpp, agcp, beta)
            p_xdist, _, _ = cubature(ctl, param, mu0, sigma0, noise)
            kl_any = (gaussian_kl(p_xdist, q) > FP_TOL).any(dim=-1)
            return param, diverged, kl_any, damp(q, p_xdist, 1e-1)

        rows = beta.shape[0]
        dummy = MatrixNormalParams(mu=agcp.new_zeros(rows, T, p),
                                   sigma=torch.eye(p, **kw).expand(rows, T, p, p))
        # the scan engine is jax.vmap's while loop: every row freezes alone
        _, param, diverged, _ = fixed_point_loop(trip, xdist0, dummy, rows, 1, fp_iters,
                                                 _select, device)
        return param, diverged

    def nominal_kl(param, nominal):
        return gaussian_kl(GaussianSequence(mu=param.mu, sigma=param.sigma),
                           GaussianSequence(mu=nominal.mu, sigma=nominal.sigma)).sum(-1)

    def dual_at(reference, scale, ctl, cost, xdist, mu0, sigma0, noise, G=1):
        """The adversary at dual ``scale`` (instance-major rows, ``G`` per
        instance) anchored at ``reference``: (param, diverged)."""
        ref = _rows(reference, G)
        agCpp, agcp, _ = parameter_augment_cost(ref, scale)
        param, diverged = fixed_point(
            agCpp, agcp, _rows(ctl, G), _rows(cost, G), _rows(xdist, G), scale,
            _rows(mu0, G), _rows(sigma0, G), _rows(noise, G), G)
        return param, diverged, ref

    def bisect(grad_at, x0, bound, iters, lo0, split):
        """The reference's geometric bisection (mbrgps.py:419-451), per instance,
        as a fixed-length loop that stops once every instance is done."""
        N = x0.shape[0]
        x, min_x, max_x = x0, torch.full((N,), lo0, **kw), torch.full((N,), big, **kw)
        chosen, best_x = x0, x0
        best_g = torch.full((N,), math.inf, **kw)
        done = torch.zeros(N, dtype=torch.bool, device=device)
        for _ in range(iters):
            hg, bad = grad_at(x)
            upd = ~done
            better = upd & ~bad & (hg < best_g)
            best_x = torch.where(better, x, best_x)
            best_g = torch.where(better, hg, best_g)
            hit = upd & ~bad & (hg.abs() < 0.1 * bound)
            chosen = torch.where(hit, x, chosen)
            done = done | hit
            max_x = torch.where(upd & ~bad & (hg > 0) & ~hit, x, max_x)
            min_x = torch.where(upd & (bad | (~bad & (hg <= 0) & ~hit)), x, min_x)
            x = torch.where(done, x, split(min_x, max_x))
            if bool(done.all()):
                break
        return torch.where(done, chosen, best_x)

    def adversary(ctl, cost, xdist, nominal, mu0, sigma0, noise):
        bound = param_nominal_kl_bound

        def grad_at(beta):
            param, diverged, _ = dual_at(nominal, beta, ctl, cost, xdist, mu0, sigma0, noise)
            hg = bound - nominal_kl(param, nominal)
            return hg, diverged | ~torch.isfinite(hg)

        N = mu0.shape[0]
        beta_star = bisect(grad_at, torch.full((N,), 1e16, **kw), bound, beta_iters, 1e-4,
                           lambda lo, hi: torch.sqrt(lo * hi))
        return dual_at(nominal, beta_star, ctl, cost, xdist, mu0, sigma0, noise)[0], beta_star

    def adversary_parallel(ctl, cost, xdist, nominal, mu0, sigma0, noise):
        """``beta_grid`` candidates per round through one batched fixed point,
        the bracket shrunk to the adjacent sign change (rgps.py:362-433)."""
        bound = param_nominal_kl_bound
        N, G = mu0.shape[0], beta_grid
        f = torch.arange(1, G + 1, **kw) / (G + 1)
        lo, hi = torch.full((N,), 1e-4, **kw), torch.full((N,), big, **kw)
        chosen, best_b = torch.full((N,), 1e16, **kw), torch.full((N,), 1e16, **kw)
        best_g = torch.full((N,), math.inf, **kw)
        done = torch.zeros(N, dtype=torch.bool, device=device)
        for _ in range(beta_rounds):
            betas = lo[:, None] * (hi / lo)[:, None] ** f
            param, diverged, ref = dual_at(nominal, betas.reshape(-1), ctl, cost, xdist, mu0,
                                           sigma0, noise, G)
            hg = (bound - nominal_kl(param, ref)).reshape(N, G)
            bad = diverged.reshape(N, G) | ~torch.isfinite(hg)
            valid = ~bad
            hgm = torch.where(valid, hg, math.inf)
            i_best = hgm.argmin(dim=1, keepdim=True)
            g_best = hgm.gather(1, i_best)[:, 0]
            better = ~done & valid.gather(1, i_best)[:, 0] & (g_best < best_g)
            best_b = torch.where(better, betas.gather(1, i_best)[:, 0], best_b)
            best_g = torch.where(better, g_best, best_g)
            hit = valid & (hg.abs() < 0.1 * bound)
            i_hit = torch.where(hit, hg.abs(), math.inf).argmin(dim=1, keepdim=True)
            any_hit = hit.any(dim=1)
            chosen = torch.where(~done & any_hit, betas.gather(1, i_hit)[:, 0], chosen)
            too_small = bad | (hg <= 0)
            lo_n = torch.maximum(torch.where(too_small, betas, lo[:, None]).amax(dim=1), lo)
            hi_n = torch.minimum(torch.where(valid & (hg > 0), betas, hi[:, None]).amin(dim=1), hi)
            lo = torch.where(done | any_hit, lo, lo_n)
            hi = torch.where(done | any_hit, hi, hi_n)
            done = done | any_hit
        beta_star = torch.where(done, chosen, best_b)
        return dual_at(nominal, beta_star, ctl, cost, xdist, mu0, sigma0, noise)[0], beta_star

    def regularized_adversary(ctl, cost, xdist, nominal, mu0, sigma0, noise):
        """Small-KL η-bisected steps anchored at the last accepted iterate until
        the KL-to-nominal budget is spent (mbrgps.py:633-676, rgps.py:435-502)."""
        reg_bound, nom_bound = param_regularizer_kl_bound, param_nominal_kl_bound

        def eta_bisect(last, eta0):
            def grad_at(eta):
                param, diverged, _ = dual_at(last, eta, ctl, cost, xdist, mu0, sigma0, noise)
                hg = reg_bound - nominal_kl(param, last)
                return hg, diverged | ~torch.isfinite(hg)

            return bisect(grad_at, eta0, reg_bound, eta_iters, 1e-4,
                          lambda lo, hi: torch.sqrt(lo) * torch.sqrt(hi))

        N = mu0.shape[0]
        last, eta = nominal, torch.full((N,), 1e16, **kw)
        done = torch.zeros(N, dtype=torch.bool, device=device)
        for _ in range(reg_steps):
            eta = eta_bisect(last, eta)
            param, diverged, _ = dual_at(last, eta, ctl, cost, xdist, mu0, sigma0, noise)
            reg_kl = nominal_kl(param, last)
            ok = ~done & ~diverged & ((reg_kl - reg_bound).abs() < 0.1 * reg_bound)
            last = _select(ok, param, last)
            done = done | (nominal_kl(last, nominal) >= nom_bound)
        return last, eta

    # ---------------------------------------------------------------- policy side
    def policy_kl_at(log_alpha, cost, ctl, param, mu0, sigma0, noise):
        """``log_alpha`` (N,) for the summed dual, (N, T) for the stepwise one."""
        alpha = (10.0 ** log_alpha).reshape(log_alpha.shape[0], -1).expand(-1, T)
        lgc, _, diverged = policy_backward_pass(augment_cost_kl(cost, ctl, alpha), param,
                                                noise, alpha)
        xdist, _, _ = cubature(lgc, param, mu0, sigma0, noise)
        klt = policy_kl(lgc, ctl, xdist)
        return (klt if policy_kl_stepwise else klt.sum(-1)), diverged, lgc

    def alpha_root(cost, ctl, param, mu0, sigma0, noise):
        N = mu0.shape[0]
        bound = policy_kl_bound
        if policy_kl_stepwise:
            la = torch.zeros(N, T, **kw)
            for _ in range(alpha_bisect_iters):
                kl, diverged, _ = policy_kl_at(la, cost, ctl, param, mu0, sigma0, noise)
                step = 0.5 * torch.log10(torch.clamp(kl, min=1e-14) / bound)
                la = torch.clamp(torch.where(diverged[:, None], la + 1.0, la + step),
                                 LOG_LO, LOG_HI)
            return la
        lo, hi = torch.full((N,), LOG_LO, **kw), torch.full((N,), LOG_HI, **kw)
        if alpha_search == "parallel":
            G = alpha_grid
            f = torch.arange(1, G + 1, **kw) / (G + 1)
            args = [_rows(x, G) for x in (cost, ctl, param, mu0, sigma0, noise)]
            for _ in range(alpha_rounds):
                las = lo[:, None] + (hi - lo)[:, None] * f
                kl, diverged, _ = policy_kl_at(las.reshape(-1), *args)
                too_small = diverged.reshape(N, G) | (kl.reshape(N, G) > bound)
                lo_n = torch.maximum(torch.where(too_small, las, lo[:, None]).amax(dim=1), lo)
                hi = torch.minimum(torch.where(~too_small, las, hi[:, None]).amin(dim=1), hi)
                lo = lo_n
            return 0.5 * (lo + hi)
        for _ in range(alpha_bisect_iters):
            mid = 0.5 * (lo + hi)
            kl, diverged, _ = policy_kl_at(mid, cost, ctl, param, mu0, sigma0, noise)
            too_small = diverged | (kl > bound)
            lo, hi = torch.where(too_small, mid, lo), torch.where(too_small, hi, mid)
        return 0.5 * (lo + hi)

    def policy(ctl, cost, param, mu0, sigma0, noise):
        log_alpha = alpha_root(cost, ctl, param, mu0, sigma0, noise)
        kl, diverged, lgc = policy_kl_at(log_alpha, cost, ctl, param, mu0, sigma0, noise)
        return lgc, kl, diverged, 10.0 ** log_alpha

    # ------------------------------------------------------------------ scoring
    def expected_cost(cost, xdist, udist):
        """The exact quadratic expectation with the covariance traces
        (rgps/objects.py:128-142)."""
        base = evaluate_quadratic_cost(cost, xdist.mu, udist.mu)
        tx = (cost.Cxx * xdist.sigma.mT).sum(dim=(-3, -2, -1))
        tu = (cost.Cuu[:, : T - 1] * udist.sigma[:, :-1].mT).sum(dim=(-3, -2, -1))
        return base + tx + tu

    def propagate(lgc, mu0, sigma0):
        _, _, lgd, ret = _propagate(env, weighting, lgc, mu0, sigma0)
        return vec_from_matrices(lgd.A, lgd.B, lgd.c), ret

    # ------------------------------------------------------------------ main loop
    def iteration(state: RGPSState) -> RGPSState:
        mu0, sigma0 = state.xdist.mu[:, 0], state.xdist.sigma[:, 0]
        with record_function("rgps.adversary"):
            if optimize_adversary:
                adv = (regularized_adversary if iterative_adversary
                       else adversary_parallel if beta_search == "parallel" else adversary)
                param, beta = adv(state.ctl, state.cost, state.xdist, state.nominal, mu0,
                                  sigma0, state.noise)
            else:
                param, beta = state.nominal, state.beta
        with record_function("rgps.policy"):
            lgc, kl, diverged, alpha = policy(state.ctl, state.cost, param, mu0, sigma0,
                                              state.noise)
            kl = kl.reshape(kl.shape[0], -1)
            accept = (kl < 1.25 * policy_kl_bound).all(dim=-1) & ~diverged
        with record_function("rgps.propagate"):
            if variant == "mb":
                nominal_mu_n, ret = propagate(lgc, mu0, sigma0)
                nominal_n = MatrixNormalParams(mu=nominal_mu_n, sigma=state.nominal.sigma)
            else:
                nominal_n = state.nominal
            xdist_n, udist_n, _ = cubature(lgc, param, mu0, sigma0, state.noise)
            if variant == "lr":
                ret = expected_cost(state.cost, xdist_n, udist_n)
        with record_function("rgps.quadratize"):
            cost_n = quadratize(xdist_n.mu, udist_n.mu)
        return RGPSState(
            ctl=_select(accept, lgc, state.ctl), xdist=_select(accept, xdist_n, state.xdist),
            udist=_select(accept, udist_n, state.udist), cost=_select(accept, cost_n, state.cost),
            nominal=_select(accept, nominal_n, state.nominal), noise=state.noise,
            last_return=torch.where(accept, ret, state.last_return), beta=beta, alpha=alpha)

    def init(mu0s: Tensor, sigma0s: Tensor) -> RGPSState:
        _check_input(mu0s, kw)
        N = mu0s.shape[0]
        ctl0 = LinearGaussianPolicy(
            K=torch.zeros(N, T, du, dx, **kw), kff=torch.zeros(N, T, du, **kw),
            sigma=(init_action_sigma * torch.eye(du, **kw)).expand(N, T, du, du))
        nominal_sigma = (nominal_variance * torch.eye(p, **kw)).expand(N, T, p, p)
        noise0 = noise_fixed.expand(N, T, dx, dx)
        if variant == "lr":
            A, B, c = (m.to(**kw) for m in env._ABc())
            nominal0 = MatrixNormalParams(mu=vec_from_matrices(A, B, c).expand(N, T, p),
                                          sigma=nominal_sigma)
        else:
            nominal_mu0, ret0 = propagate(ctl0, mu0s, sigma0s)
            nominal0 = MatrixNormalParams(mu=nominal_mu0, sigma=nominal_sigma)
        xdist0, udist0, _ = cubature(ctl0, nominal0, mu0s, sigma0s, noise0)
        cost0 = quadratize(xdist0.mu, udist0.mu)
        if variant == "lr":
            ret0 = expected_cost(cost0, xdist0, udist0)
        return RGPSState(
            ctl=ctl0, xdist=xdist0, udist=udist0, cost=cost0, nominal=nominal0, noise=noise0,
            last_return=ret0, beta=torch.full((N,), 1e16, **kw),
            alpha=torch.full((N, T) if policy_kl_stepwise else (N,), 1e8, **kw))

    def solve(mu0s: Tensor, sigma0s: Tensor):
        state = init(mu0s, sigma0s)
        traces = [state.last_return]
        for _ in range(nb_iter):
            state = iteration(state)
            traces.append(state.last_return)
        return state, torch.stack(traces, dim=1)

    solve.init = init
    solve.iteration = iteration
    solve.fixed_points = 0
    solve.fp_engine = fp_engine
    return solve


def rgps_batch_initial_states(env, generator: torch.Generator | None, nb_problems: int,
                              init_spread: float = 0.1, *, device="cuda",
                              dtype: torch.dtype = torch.float32):
    """The perturbed initial states of :func:`run_rgps_batch`: ``mu0 +
    init_spread·N(0, I)`` drawn from ``generator``, and ``sigma0`` tiled."""
    kw = dict(dtype=dtype, device=_resolve(device))
    mu0, sigma0 = (x.to(**kw) for x in env.init())
    z = standard_normal((nb_problems, env.dm_state), generator, **kw)
    return mu0 + init_spread * z, sigma0.expand(nb_problems, *sigma0.shape)


def run_rgps_batch(env, generator: torch.Generator | None, nb_problems: int, nb_steps: int,
                   variant: str = "lr", nb_iter: int = 5, mesh=None, init_spread: float = 0.1,
                   mu0s: Tensor | None = None, *, device="cuda",
                   dtype: torch.dtype = torch.float32, **rgps_kwargs):
    """A batch of robust-GPS solves from perturbed initial states (drawn by
    :func:`rgps_batch_initial_states`, or handed in as ``mu0s``), all
    instances in one batched solve.  Returns ``{"trace": (N, nb_iter+1),
    "K"/"kff"/"sigma": the final controllers}``."""
    if mesh is not None:
        raise _not_ported_mesh("sharding the robust-GPS batch over a mesh")
    solve = make_rgps_solver_batched(env, nb_steps, variant, nb_iter, device=device,
                                     dtype=dtype, **rgps_kwargs)
    draws, sigma0s = rgps_batch_initial_states(env, generator, nb_problems, init_spread,
                                               device=device, dtype=dtype)
    state, trace = solve(draws if mu0s is None else mu0s, sigma0s)
    return {"trace": trace, "K": state.ctl.K, "kff": state.ctl.kff, "sigma": state.ctl.sigma}
