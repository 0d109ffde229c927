"""iLQR solvers and MPC drivers (counterpart of ``trajopt_tpu/parallel/mpc.py``).

One iteration: linearize → λ-escalated backward → α-grid line search → pick
the first acceptable α → accept or reject.

* :func:`make_ilqr_solver` solves one problem; its backward engines are
  ``"scan"`` (``core/scan_lqr``), ``"pscan"`` (``core/pscan_lqr``, the
  parallel-in-time pass with λ folded into Cuu) and ``"cuda-pscan"`` (the same
  pass as one launch of kernel K5).
* :func:`make_ilqr_solver_batched` solves a batch with finished instances
  frozen; the batch axis is primal, so each backward pass and each
  line-search phase is one launch over all instances.  Backward engines:
  ``"scan"``, ``"cuda"`` (expand with ``core/diff``, then kernel K4) and
  ``"cuda-fused"`` (kernel K1 linearizes and quadratizes in-kernel).  Rollout
  engines: ``"scan"`` (``solvers/common.rollout_tracking`` over the α grid)
  and ``"cuda"`` (kernel K2 for every α's return, kernel K3 to roll the
  selected α out again).
* :func:`make_mpc_runner`, :func:`make_mpc_runner_batched` and
  :func:`run_mpc_batch` drive receding-horizon MPC on the noisy system.

On CPU tensors the kernel wrappers run their plain versions.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch import Tensor

from ..core.cuda_fused import cuda_ilqr_backward_fused
from ..core.cuda_lqr import (
    cuda_ilqr_backward_packed,
    from_soa,
    lane_pad,
    pack_lanes,
    pad_lanes,
    to_soa,
)
from ..core.cuda_rollout import (
    cuda_rollout_returns,
    cuda_rollout_selected,
    pack_rollout,
    unpack_selected,
)
from ..core.cuda_pscan import cuda_pilqr_backward_reg
from ..core.diff import linearize_dynamics_delta, quadratize_cost_delta
from ..core.pscan_lqr import pilqr_backward_reg
from ..core.scan_lqr import ilqr_backward
from ..core.types import LinearPolicy
from ..envs.base import gaussian
from ..solvers.common import DEFAULT_ALPHAS, make_weighting, rollout_tracking


class ILQRIterMetrics(NamedTuple):
    """Per-iteration metrics of the solver when ``metrics=True``."""

    ret: Tensor      # accepted return after this iteration
    lmbda: Tensor    # LM regularizer after accept/reject
    dlmbda: Tensor   # LM multiplier state
    done: Tensor     # convergence flag


class ILQRState(NamedTuple):
    """Solver state: unbatched from :func:`make_ilqr_solver`, batch-leading
    (an ``(N,)`` axis in front of each field) from
    :func:`make_ilqr_solver_batched`."""

    xref: Tensor         # (T+1, dx)
    uref: Tensor         # (T, du)
    K: Tensor            # (T, du, dx)
    kff: Tensor          # (T, du)
    lmbda: Tensor        # ()
    dlmbda: Tensor       # ()
    last_return: Tensor  # ()
    done: Tensor         # () bool


def _bcast(mask: Tensor, ndim: int) -> Tensor:
    return mask.reshape((-1,) + (1,) * (ndim - 1))


def _resolve(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def _not_ported_mesh(what: str):
    return NotImplementedError(
        f"{what} is not ported yet (ROADMAP.md queue 1, row 17: multi-GPU)"
    )


def make_ilqr_solver(
    env,
    nb_steps: int,
    nb_iter: int = 10,
    activation: dict | None = None,
    alphas=DEFAULT_ALPHAS,
    lmbda: float = 1.0,
    min_lmbda: float = 1e-6,
    max_lmbda: float = 1e6,
    mult_lmbda: float = 1.6,
    tolfun: float = 1e-6,
    tolgrad: float = 1e-4,
    min_imp: float = 0.0,
    reg: int = 1,
    backward: str = "scan",
    time_mesh=None,
    time_axis: str = "time",
    metrics: bool = False,
    *,
    device="cuda",
    dtype: torch.dtype = torch.float32,
):
    """Single-problem iLQR: ``solve(x0 (dx,), kff_init (T, du) | None) ->
    (state, trace)``, the iLQR outer loop of ilqr/ilqr.py:136-237.

    Semantics kept: λ escalation with bail-out above ``max_lmbda`` (a host
    ``while``, with the reference's extra call at λ0 before the loop),
    first-accept backtracking over the α grid (all α rolled out at once),
    gradient-norm and tolfun termination, λ zeroed below ``min_lmbda``, and
    no work once the solve is done.  ``trace`` stacks the accepted return of
    every iteration ``(nb_iter,)`` (or :class:`ILQRIterMetrics` of such stacks
    when ``metrics=True``).

    Backward engines: ``"scan"`` (sequential, reg ∈ {1, 2}); ``"pscan"``
    (parallel in time, λ folded into Cuu, ``reg`` ignored; a non-PD step gives
    NaN and flags divergence); ``"cuda-pscan"`` (the same pass as one launch of
    kernel K5, whose Cholesky guard keeps a non-PD step finite and unflagged,
    as the TPU kernel does).  Each host-side decision (the λ loop's condition,
    the done test) syncs with the device once.
    """
    if time_mesh is not None:
        raise _not_ported_mesh("horizon sharding (time_mesh)")
    del time_axis
    if backward == "scan":
        def bwd(cost, A, B, lam):
            pol, _, _, dV, div = ilqr_backward(cost, A, B, lam, reg)
            return pol, dV, div
    elif backward in ("pscan", "cuda-pscan"):
        engine = pilqr_backward_reg if backward == "pscan" else cuda_pilqr_backward_reg

        def bwd(cost, A, B, lam):
            pol, _, dV, div = engine(cost, A, B, lam)
            return pol, dV, div
    else:
        raise ValueError(f"unknown backward impl {backward!r}")
    T = nb_steps
    dx, du = env.dm_state, env.dm_act
    device = _resolve(device)
    kw = dict(dtype=dtype, device=device)
    weighting = make_weighting(T, activation, **kw)
    alphas = torch.tensor(tuple(float(a) for a in alphas), **kw)
    nA = alphas.shape[0]

    def forward_all(K, kff, xref, uref):
        """Rollout of every α: each output has a leading ``(nA,)`` axis."""
        def grid(x):
            return x.expand(nA, *x.shape)

        return rollout_tracking(env, LinearPolicy(K=grid(K), kff=grid(kff)), alphas,
                                grid(xref[0]), grid(xref), grid(uref), weighting)

    def pick(x, idx):
        return x.index_select(0, idx.reshape(1)).squeeze(0)

    def backward_with_lm(cost, A, B, lmbda0, dlmbda0):
        """λ-escalation loop (ilqr.py:160-173); the first trip repeats the λ0
        call before the loop, as the reference does."""
        out = bwd(cost, A, B, lmbda0)
        lmbda, dlmbda = lmbda0, dlmbda0
        diverged = torch.zeros((), dtype=torch.bool, device=device)
        first = True
        while bool((diverged | first) & (lmbda <= max_lmbda)):
            out = bwd(cost, A, B, lmbda)
            new_div = out[2]
            dlmbda = torch.where(new_div, (dlmbda * mult_lmbda).clamp(min=mult_lmbda), dlmbda)
            lmbda = torch.where(new_div, (lmbda * dlmbda).clamp(min=min_lmbda), lmbda)
            diverged, first = new_div, False
        return out, lmbda, dlmbda, diverged

    def work(state: ILQRState) -> ILQRState:
        A, B = linearize_dynamics_delta(env.dynamics, state.xref[:T], state.uref)
        cost = quadratize_cost_delta(env.cost, state.xref, state.uref, weighting)
        (ctl, dV, _), lmbda, dlmbda, diverged = backward_with_lm(
            cost, A, B, state.lmbda, state.dlmbda
        )
        g_norm = (ctl.kff.abs() / (state.uref.abs() + 1.0)).amax(dim=0).mean()
        grad_done = (g_norm < tolgrad) & (lmbda < 1e-5)

        states_all, actions_all, costs_all = forward_all(ctl.K, ctl.kff, state.xref, state.uref)
        returns = costs_all.sum(dim=1)
        dreturns = state.last_return - returns
        expected = -1.0 * alphas * (dV[0] + alphas * dV[1])
        imp = dreturns / expected                                      # IEEE x/0
        ok = (imp >= min_imp) & ~diverged & torch.isfinite(returns)
        accepted = ok.any()
        idx = ok.to(torch.uint8).argmax()                              # first acceptable α

        dlmbda_acc = (dlmbda / mult_lmbda).clamp(max=1.0 / mult_lmbda)
        lmbda_acc = lmbda * dlmbda_acc * (lmbda > min_lmbda)
        dlmbda_rej = (dlmbda * mult_lmbda).clamp(min=mult_lmbda)
        lmbda_rej = (lmbda * dlmbda_rej).clamp(min=min_lmbda)

        take = accepted & ~grad_done
        return ILQRState(
            xref=torch.where(take, pick(states_all, idx), state.xref),
            uref=torch.where(take, pick(actions_all, idx), state.uref),
            K=torch.where(take, ctl.K, state.K),
            kff=torch.where(take, ctl.kff, state.kff),
            lmbda=torch.where(take, lmbda_acc, lmbda_rej),
            dlmbda=torch.where(take, dlmbda_acc, dlmbda_rej),
            last_return=torch.where(take, pick(returns, idx), state.last_return),
            done=(
                grad_done
                | (take & (pick(dreturns, idx) < tolfun))
                | (~accepted & (lmbda_rej > max_lmbda))
            ),
        )

    def solve(x0: Tensor, kff_init: Tensor | None = None):
        if x0.device != device or x0.dtype != dtype:
            raise ValueError(
                f"x0 is {x0.dtype} on {x0.device}; this solver was built for "
                f"{dtype} on {device}"
            )
        xref0 = torch.zeros(T + 1, dx, **kw)
        xref0[0] = x0
        kff0 = torch.zeros(T, du, **kw) if kff_init is None else kff_init
        K0 = torch.zeros(T, du, dx, **kw)

        # the initial trajectory: the first candidate of the α grid that stays
        # below 1e8 (ilqr.py:139-148)
        states_all, actions_all, costs_all = forward_all(K0, kff0, xref0, torch.zeros(T, du, **kw))
        idx = (states_all < 1e8).all(dim=2).all(dim=1).to(torch.uint8).argmax()
        state = ILQRState(
            xref=pick(states_all, idx), uref=pick(actions_all, idx), K=K0, kff=kff0,
            lmbda=torch.tensor(lmbda, **kw), dlmbda=torch.tensor(1.0, **kw),
            last_return=pick(costs_all, idx).sum(),
            done=torch.zeros((), dtype=torch.bool, device=device),
        )
        outs = []
        for _ in range(nb_iter):
            if not bool(state.done):
                state = work(state)
            outs.append(ILQRIterMetrics(state.last_return, state.lmbda, state.dlmbda, state.done)
                        if metrics else state.last_return)
        if metrics:
            return state, ILQRIterMetrics(*(torch.stack(f) for f in zip(*outs)))
        return state, torch.stack(outs)

    return solve


def make_ilqr_solver_batched(
    env,
    nb_steps: int,
    nb_iter: int = 10,
    activation: dict | None = None,
    alphas=DEFAULT_ALPHAS,
    lmbda: float = 1.0,
    min_lmbda: float = 1e-6,
    max_lmbda: float = 1e6,
    mult_lmbda: float = 1.6,
    tolfun: float = 1e-6,
    tolgrad: float = 1e-4,
    min_imp: float = 0.0,
    reg: int = 1,
    backward: str = "scan",
    time_chunk: int = 8,
    fast_line_search: bool = False,
    metrics: bool = False,
    rollout: str = "scan",
    differentiable: bool = False,
    *,
    device="cuda",
    dtype: torch.dtype = torch.float32,
):
    """Batch-native iLQR: ``solve(x0s (N, dx), kff_init (N, T, du) | None) ->
    (state, trace)``, with the accept/reject semantics of the JAX solver.

    ``trace`` stacks the accepted return of every iteration ``(nb_iter, N)``
    (or :class:`ILQRIterMetrics` of such stacks when ``metrics=True``).
    ``solve.init(x0s, kff_init)`` gives the state before the first iteration
    and ``solve.iteration(state) -> (state, out)`` runs one iteration from a
    given state (a warm start).  ``time_chunk`` exists so reference call sites
    run unchanged: the CUDA kernels keep the whole horizon in one thread and
    tile no time axis.  The global λ loop syncs with the host once per trip to
    test whether any instance still needs escalation.
    """
    if fast_line_search:
        raise NotImplementedError(
            "fast_line_search is not ported yet (ROADMAP.md queue 1, row 4a)"
        )
    if differentiable:
        raise NotImplementedError(
            "differentiable solves are not ported yet (ROADMAP.md queue 1, row 4b)"
        )
    if backward not in ("scan", "cuda", "cuda-fused"):
        raise ValueError(f"unknown backward impl {backward!r}")
    if rollout not in ("scan", "cuda"):
        raise ValueError(f"unknown rollout impl {rollout!r}")
    if backward == "cuda-fused" and not getattr(env, "supports_tile_quadratization", False):
        raise ValueError(
            "backward='cuda-fused' needs a tile-protocol env with the base "
            f"feature-goal cost; {type(env).__name__} does not qualify"
        )
    if rollout == "cuda" and not getattr(env, "supports_tiles", False):
        raise ValueError(
            f"rollout='cuda' needs a tile-protocol env; {type(env).__name__} "
            "does not define one"
        )
    del time_chunk
    T = nb_steps
    dx, du = env.dm_state, env.dm_act
    device = _resolve(device)
    kw = dict(dtype=dtype, device=device)
    weighting = make_weighting(T, activation, **kw)
    alphas = torch.tensor(tuple(float(a) for a in alphas), **kw)

    def backward_with_lm(bwd, select, lmbda0, dlmbda0, frozen):
        """Global λ-escalation loop with per-instance masking: iterate while
        any live instance still needs escalation, freeze the rest.  The first
        trip repeats the λ0 call before the loop, as the reference does."""
        N = lmbda0.shape[0]
        gains, dV, _ = bwd(lmbda0)
        lmbda, dlmbda = lmbda0, dlmbda0
        diverged = torch.zeros(N, dtype=torch.bool, device=device)
        first = torch.ones(N, dtype=torch.bool, device=device)
        while True:
            active = (first | diverged) & (lmbda <= max_lmbda) & ~frozen
            if not bool(active.any()):
                break
            gains_n, dV_n, div_n = bwd(lmbda)
            gains = tuple(select(active, a, b) for a, b in zip(gains_n, gains))
            dV = torch.where(active[:, None], dV_n, dV)
            diverged = torch.where(active, div_n, diverged)
            esc = active & div_n
            dlmbda = torch.where(esc, (dlmbda * mult_lmbda).clamp(min=mult_lmbda), dlmbda)
            lmbda = torch.where(esc, (lmbda * dlmbda).clamp(min=min_lmbda), lmbda)
            first = torch.zeros_like(first)
        return gains, dV, lmbda, dlmbda, diverged

    def select_batch(m, a, b):
        return torch.where(_bcast(m, a.dim()), a, b)

    def forward_all(K, kff, xref, uref):
        """Scan rollout of every α for every instance: each (N, nA, ...)."""
        N, nA = K.shape[0], alphas.shape[0]

        def grid(x):
            return x.unsqueeze(1).expand(N, nA, *x.shape[1:])

        pol = LinearPolicy(K=grid(K), kff=grid(kff))
        return rollout_tracking(
            env, pol, alphas.expand(N, nA), grid(xref[:, 0]), grid(xref),
            grid(uref), weighting,
        )

    def line_search_cuda(streams, N):
        ret_l, ok_l = cuda_rollout_returns(env, *streams, weighting, alphas)
        return ret_l[:, :N].T, ok_l[:, :N].T

    def select_cuda(streams, alpha_sel, N, n_pad):
        xs_l, us_l, xT_l, _ = cuda_rollout_selected(
            env, *streams, weighting, pad_lanes(alpha_sel, n_pad)
        )
        return unpack_selected(xs_l, us_l, xT_l, N)

    def iteration(state: ILQRState):
        N = state.lmbda.shape[0]
        n_pad = lane_pad(N)
        lanes = backward != "scan"
        if backward == "cuda-fused":
            xr_l = to_soa(state.xref[:, :T], n_pad)
            ur_l = to_soa(state.uref, n_pad)
            ulast = torch.cat([torch.zeros_like(state.uref[:, :1]), state.uref[:, :-1]], dim=1)
            ul_l = to_soa(ulast, n_pad)
            xT_l = to_soa(state.xref[:, T:], n_pad)[0]

            def bwd(lam):
                K_l, kff_l, dV_l, bad_l = cuda_ilqr_backward_fused(
                    env, xr_l, ur_l, ul_l, xT_l, weighting, pad_lanes(lam, n_pad), reg
                )
                return (K_l, kff_l), dV_l[:, :N].T, bad_l[:N]
        else:
            A, B = linearize_dynamics_delta(env.dynamics, state.xref[:, :T], state.uref)
            cost = quadratize_cost_delta(env.cost, state.xref, state.uref, weighting)
            if backward == "cuda":
                packed = pack_lanes(cost, A, B, n_pad)

                def bwd(lam):
                    K_l, kff_l, dV_l, bad_l = cuda_ilqr_backward_packed(
                        packed, pad_lanes(lam, n_pad), reg
                    )
                    return (K_l, kff_l), dV_l[:, :N].T, bad_l[:N]
            else:
                def bwd(lam):
                    pol, _, _, dV, div = ilqr_backward(cost, A, B, lam, reg)
                    return (pol.K, pol.kff), dV, div

        if lanes:
            def select(m, a, b):
                return torch.where(pad_lanes(m, n_pad), a, b)
        else:
            select = select_batch

        gains, dV, lmbda, dlmbda, diverged = backward_with_lm(
            bwd, select, state.lmbda, state.dlmbda, state.done
        )
        if lanes:
            K_n, kff_n = from_soa(gains[0], N, (du, dx)), from_soa(gains[1], N, (du,))
        else:
            K_n, kff_n = gains
        backpass_done = ~diverged

        g_norm = (kff_n.abs() / (state.uref.abs() + 1.0)).amax(dim=1).mean(dim=-1)
        grad_done = (g_norm < tolgrad) & (lmbda < 1e-5)

        if rollout == "cuda":
            if backward == "cuda-fused":
                streams = (gains[0], gains[1], xr_l, ur_l)
            elif backward == "cuda":
                streams = (gains[0], gains[1], to_soa(state.xref[:, :T], n_pad),
                           to_soa(state.uref, n_pad))
            else:
                streams = pack_rollout(K_n, kff_n, state.xref, state.uref, n_pad)
            returns, _ = line_search_cuda(streams, N)
        else:
            states_all, actions_all, costs_all = forward_all(
                K_n, kff_n, state.xref, state.uref
            )
            returns = costs_all.sum(dim=2)                             # (N, nA)
        dreturns = state.last_return[:, None] - returns
        expected = -1.0 * alphas[None] * (dV[:, :1] + alphas[None] * dV[:, 1:])
        imp = dreturns / expected                                      # IEEE x/0
        ok = (imp >= min_imp) & backpass_done[:, None] & torch.isfinite(returns)
        accepted = ok.any(dim=1)
        idx = ok.to(torch.uint8).argmax(dim=1)                         # first acceptable α
        rows = torch.arange(N, device=device)

        dlmbda_acc = (dlmbda / mult_lmbda).clamp(max=1.0 / mult_lmbda)
        lmbda_acc = lmbda * dlmbda_acc * (lmbda > min_lmbda)
        dlmbda_rej = (dlmbda * mult_lmbda).clamp(min=mult_lmbda)
        lmbda_rej = (lmbda * dlmbda_rej).clamp(min=min_lmbda)

        take = accepted & ~grad_done
        if rollout == "cuda":
            sel_states, sel_actions = select_cuda(streams, alphas[idx], N, n_pad)
        else:
            sel_states, sel_actions = states_all[rows, idx], actions_all[rows, idx]
        new = ILQRState(
            xref=select_batch(take, sel_states, state.xref),
            uref=select_batch(take, sel_actions, state.uref),
            K=select_batch(take, K_n, state.K),
            kff=select_batch(take, kff_n, state.kff),
            lmbda=torch.where(take, lmbda_acc, lmbda_rej),
            dlmbda=torch.where(take, dlmbda_acc, dlmbda_rej),
            last_return=torch.where(take, returns[rows, idx], state.last_return),
            done=(
                grad_done
                | (take & (dreturns[rows, idx] < tolfun))
                | (~accepted & (lmbda_rej > max_lmbda))
            ),
        )
        # finished instances keep their state
        merged = ILQRState(*(select_batch(state.done, a, b) for a, b in zip(state, new)))
        out = (
            ILQRIterMetrics(merged.last_return, merged.lmbda, merged.dlmbda, merged.done)
            if metrics else merged.last_return
        )
        return merged, out

    def init(x0s: Tensor, kff_init: Tensor | None = None) -> ILQRState:
        """The state before the first iteration: the first candidate of the α
        grid, rolled out from zero gains and ``kff_init``, that stays below 1e8."""
        if x0s.device != device or x0s.dtype != dtype:
            raise ValueError(
                f"x0s is {x0s.dtype} on {x0s.device}; this solver was built for "
                f"{dtype} on {device}"
            )
        N = x0s.shape[0]
        xref0 = torch.zeros(N, T + 1, dx, **kw)
        xref0[:, 0] = x0s
        kff0 = torch.zeros(N, T, du, **kw) if kff_init is None else kff_init
        K0 = torch.zeros(N, T, du, dx, **kw)
        uref0 = torch.zeros(N, T, du, **kw)
        rows = torch.arange(N, device=device)
        if rollout == "cuda":
            n_pad = lane_pad(N)
            streams = pack_rollout(K0, kff0, xref0, uref0, n_pad)
            rets0, oks0 = line_search_cuda(streams, N)
            idx = oks0.to(torch.uint8).argmax(dim=1)
            xref_i, uref_i = select_cuda(streams, alphas[idx], N, n_pad)
            ret_i = rets0[rows, idx]
        else:
            states_all, actions_all, costs_all = forward_all(K0, kff0, xref0, uref0)
            finite = (states_all < 1e8).all(dim=3).all(dim=2)
            idx = finite.to(torch.uint8).argmax(dim=1)
            xref_i, uref_i = states_all[rows, idx], actions_all[rows, idx]
            ret_i = costs_all[rows, idx].sum(dim=1)
        return ILQRState(
            xref=xref_i, uref=uref_i, K=K0, kff=kff0,
            lmbda=torch.full((N,), lmbda, **kw),
            dlmbda=torch.ones(N, **kw),
            last_return=ret_i,
            done=torch.zeros(N, dtype=torch.bool, device=device),
        )

    def solve(x0s: Tensor, kff_init: Tensor | None = None):
        state = init(x0s, kff_init)
        outs = []
        for _ in range(nb_iter):
            state, out = iteration(state)
            outs.append(out)
        if metrics:
            trace = ILQRIterMetrics(*(torch.stack(f) for f in zip(*outs)))
        else:
            trace = torch.stack(outs)
        return state, trace

    solve.init = init
    solve.iteration = iteration
    return solve


def make_mpc_runner(
    env,
    horizon: int,
    nb_steps: int,
    nb_iter: int = 10,
    *,
    device="cuda",
    dtype: torch.dtype = torch.float32,
    **ilqr_kwargs,
):
    """Receding-horizon MPC (examples/ilqr/mpc/pendulum.py:18-31):
    ``run(x0 (dx,), generator=None, noise=None) -> (states (nb_steps+1, dx),
    actions (nb_steps, du), costs (nb_steps,))``.

    Each control step solves iLQR from the current state, warm-started with
    the previous solution's actions shifted by one step, and applies the first
    action to the noisy system (``env.step``).  The process noise is drawn from
    ``generator``, or handed in as ``noise (nb_steps, dx)``, the additive term
    of each step."""
    solve = make_ilqr_solver(env, horizon, nb_iter=nb_iter, device=device, dtype=dtype,
                             **ilqr_kwargs)
    kw = dict(dtype=dtype, device=_resolve(device))
    du = env.dm_act
    one = torch.ones((), **kw)

    def run(x0: Tensor, generator: torch.Generator | None = None, noise: Tensor | None = None):
        x, kff_warm = x0, torch.zeros(horizon, du, **kw)
        xs, us, cs = [], [], []
        for t in range(nb_steps):
            state, _ = solve(x, kff_warm)
            u = state.uref[0]
            cs.append(env.cost(x, u, u, one))
            xs.append(x)
            us.append(u)
            x = env.step(generator, x, u, None if noise is None else noise[t])
            # shift the solution one step for warm starting
            kff_warm = torch.cat([state.uref[1:], torch.zeros(1, du, **kw)])
        return torch.stack(xs + [x]), torch.stack(us), torch.stack(cs)

    return run


def make_mpc_runner_batched(
    env,
    horizon: int,
    nb_steps: int,
    nb_iter: int = 10,
    backward: str = "scan",
    *,
    device="cuda",
    dtype: torch.dtype = torch.float32,
    **ilqr_kwargs,
):
    """Batch-native MPC: ``run(x0s (N, dx), generator=None, noise=None)``
    solves every episode's iLQR problem jointly at each control step with
    :func:`make_ilqr_solver_batched`, so each backward pass is one batched
    call.  ``noise (N, nb_steps, dx)``, when handed in, is each episode's
    additive process noise.  Returns states ``(N, nb_steps+1, dx)``, actions
    ``(N, nb_steps, du)`` and costs ``(N, nb_steps)``."""
    solve = make_ilqr_solver_batched(env, horizon, nb_iter=nb_iter, backward=backward,
                                     device=device, dtype=dtype, **ilqr_kwargs)
    kw = dict(dtype=dtype, device=_resolve(device))
    du = env.dm_act

    def run(x0s: Tensor, generator: torch.Generator | None = None,
            noise: Tensor | None = None):
        N = x0s.shape[0]
        ones = torch.ones(N, **kw)
        x, kff_warm = x0s, torch.zeros(N, horizon, du, **kw)
        xs, us, cs = [], [], []
        for t in range(nb_steps):
            state, _ = solve(x, kff_warm)
            u = state.uref[:, 0]
            cs.append(env.cost(x, u, u, ones))
            xs.append(x)
            us.append(u)
            x = env.step(generator, x, u, None if noise is None else noise[:, t])
            kff_warm = torch.cat([state.uref[:, 1:], torch.zeros(N, 1, du, **kw)], dim=1)
        return torch.stack(xs + [x], dim=1), torch.stack(us, dim=1), torch.stack(cs, dim=1)

    return run


def run_mpc_batch(
    env,
    generator: torch.Generator | None,
    nb_episodes: int,
    horizon: int,
    nb_steps: int,
    nb_iter: int = 10,
    mesh=None,
    axis_name: str = "dp",
    batched: bool = False,
    backward: str = "scan",
    *,
    device="cuda",
    dtype: torch.dtype = torch.float32,
    **ilqr_kwargs,
):
    """A batch of MPC episodes from initial states drawn with ``env.sample_init``
    (the replacement for the reference's joblib farm,
    examples/ilqr/mpc/pendulum_parallel.py).  ``batched=False`` runs
    :func:`make_mpc_runner` on each episode in turn; ``batched=True`` runs
    :func:`make_mpc_runner_batched` on all of them at once.  The initial states
    and then every episode's process noise are drawn from ``generator`` before
    the episodes run, so both modes see the same draws.  Returns ``{"x":
    states, "u": actions, "c": costs}``, episode-leading."""
    if mesh is not None:
        raise _not_ported_mesh("sharding the episodes over a mesh")
    del axis_name
    kw = dict(dtype=dtype, device=_resolve(device))
    x0s = torch.stack([env.sample_init(generator, **kw) for _ in range(nb_episodes)])
    zero = torch.zeros(nb_episodes, nb_steps, env.dm_state, **kw)
    noise = gaussian(zero, env.noise_factor(dtype, zero.device), generator)
    if batched:
        run = make_mpc_runner_batched(env, horizon, nb_steps, nb_iter=nb_iter,
                                      backward=backward, **kw, **ilqr_kwargs)
        states, actions, costs = run(x0s, noise=noise)
    else:
        # as in the reference, ``backward`` names a batched engine and reaches
        # only the batched runner
        run_one = make_mpc_runner(env, horizon, nb_steps, nb_iter=nb_iter, **kw,
                                  **ilqr_kwargs)
        outs = [run_one(x0s[i], noise=noise[i]) for i in range(nb_episodes)]
        states, actions, costs = (torch.stack(f) for f in zip(*outs))
    return {"x": states, "u": actions, "c": costs}
