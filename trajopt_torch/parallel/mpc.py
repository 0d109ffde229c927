"""Batched iLQR (counterpart of ``trajopt_tpu/parallel/mpc.py::make_ilqr_solver_batched``).

One iteration: linearize → λ-escalated backward → α-grid line search → pick
the first acceptable α per instance → accept or reject, with finished
instances frozen.  The batch axis is primal, so each backward pass and each
line-search phase is one launch over all instances.

Backward engines: ``"scan"`` (``core/scan_lqr``, a time loop of batched small
products), ``"cuda"`` (expand with ``core/diff``, then kernel K4) and
``"cuda-fused"`` (kernel K1 linearizes and quadratizes in-kernel).  Rollout
engines: ``"scan"`` (``solvers/common.rollout_tracking`` over the α grid) and
``"cuda"`` (kernel K2 for every α's return, kernel K3 to roll the selected α
out again).  On CPU tensors the kernel wrappers run their plain versions.
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
from ..core.diff import linearize_dynamics_delta, quadratize_cost_delta
from ..core.scan_lqr import ilqr_backward
from ..core.types import LinearPolicy
from ..solvers.common import DEFAULT_ALPHAS, make_weighting, rollout_tracking


class ILQRIterMetrics(NamedTuple):
    """Per-iteration metrics of the solver when ``metrics=True``."""

    ret: Tensor      # accepted return after this iteration
    lmbda: Tensor    # LM regularizer after accept/reject
    dlmbda: Tensor   # LM multiplier state
    done: Tensor     # convergence flag


class ILQRState(NamedTuple):
    """Solver state, batch-leading."""

    xref: Tensor         # (N, T+1, dx)
    uref: Tensor         # (N, T, du)
    K: Tensor            # (N, T, du, dx)
    kff: Tensor          # (N, T, du)
    lmbda: Tensor        # (N,)
    dlmbda: Tensor       # (N,)
    last_return: Tensor  # (N,)
    done: Tensor         # (N,) bool


def _bcast(mask: Tensor, ndim: int) -> Tensor:
    return mask.reshape((-1,) + (1,) * (ndim - 1))


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
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
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
