"""Compiled-loop extended LQR (counterpart of ``trajopt_tpu/parallel/elqr.py``).

A solve is the host class's loop (``solvers/elqr.eLQR.run``) as one
function: the initial rollout, then ``nb_iter`` × (forward cost-to-come
sweep, backward cost-to-go sweep, evaluation rollout), then the final
rollout, returning ``(ctl, xs, us, trace (nb_iter+1))``.

:func:`make_elqr_solver_batched` solves a batch with one of three engines:

* ``"scan"``: the sweeps of ``solvers/elqr`` on the whole batch (``torch.func``
  Jacobians per step, ``torch.linalg.inv``);
* ``"cuda"``: each sweep one launch for the whole batch, kernels K11, K12 and
  K13 of ``core/cuda_elqr`` (the counterpart of the TPU engine ``"pallas"``);
* ``"cuda-fused"``: the whole solve one launch of K14 (``"pallas-fused"``),
  the latency engine for small batches;
* ``"auto"`` (the default) picks per call (:func:`pick_engine`).

The initial feedforward is N(0, 1): ``kff_init (N, T, du)`` when given, else
drawn from ``generator``.  On CPU tensors the kernel wrappers run their
plain versions.
"""

from __future__ import annotations

import torch
from torch import Tensor

from ..core import cuda_elqr
from ..core.cuda_lqr import from_soa, to_soa
from ..core.types import LinearPolicy
from ..solvers.elqr import elqr_backward_lqr, elqr_forward_lqr, elqr_rollout, initial_values
from .mpc import _not_ported_mesh, _resolve

ENGINES = ("scan", "cuda", "cuda-fused")
FUSED_MAX_BATCH = 128  # one block of the fused solve (the TPU kernel's lane block)


def pick_engine(env, N: int, device) -> str:
    """``engine="auto"``'s choice: ``"cuda-fused"`` for N ≤ 128 and ``"cuda"``
    beyond, on a CUDA device with an env the kernels take (the base
    feature-goal cost, no slew rate, device functions); ``"scan"``
    otherwise."""
    if torch.device(device).type != "cuda":
        return "scan"
    try:
        cuda_elqr.check_env(env)
    except ValueError:
        return "scan"
    return "cuda-fused" if N <= FUSED_MAX_BATCH else "cuda"


def _draw_kff(N, T, du, generator, kw) -> Tensor:
    where = generator.device if generator is not None else kw["device"]
    z = torch.randn(N, T, du, generator=generator, dtype=kw["dtype"], device=where)
    return z.to(kw["device"])


def _solve_scan(env, T, nb_iter, x0s, kff0):
    N, dx = x0s.shape
    ctl = LinearPolicy(K=x0s.new_zeros(N, T, env.dm_act, dx), kff=kff0)
    gocost = initial_values(T, dx, (N,), x0s.dtype, x0s.device)
    trace = [elqr_rollout(env, ctl, x0s)[2].sum(-1)]
    state = x0s
    for _ in range(nb_iter):
        state, ictl, comecost = elqr_forward_lqr(env, state, ctl, gocost.V, gocost.v)
        state, ctl, gocost = elqr_backward_lqr(env, state, ictl, *comecost)
        trace.append(elqr_rollout(env, ctl, x0s)[2].sum(-1))
    xs, us, _ = elqr_rollout(env, ctl, x0s)
    return ctl, xs, us, torch.stack(trace, -1)


def _solve_cuda(env, T, nb_iter, x0s, kff0):
    N, dx = x0s.shape
    du = env.dm_act
    x0 = x0s.T.contiguous()
    K = x0s.new_zeros(T, du * dx, N)
    kff = to_soa(kff0, N)
    goV = x0s.new_zeros(T + 1, dx * dx, N)
    gov = x0s.new_zeros(T + 1, dx, N)
    rets = [cuda_elqr.cuda_elqr_rollout(env, K, kff, x0)]
    state = x0
    for _ in range(nb_iter):
        iK, ikff, comeV, comev, _, state = cuda_elqr.cuda_elqr_forward(env, K, kff, goV, gov,
                                                                       state)
        K, kff, goV, gov, _, state = cuda_elqr.cuda_elqr_backward(env, iK, ikff, comeV, comev,
                                                                  state)
        rets.append(cuda_elqr.cuda_elqr_rollout(env, K, kff, x0))
    _, xs, us = cuda_elqr.cuda_elqr_rollout(env, K, kff, x0, store=True)
    return K, kff, xs, us, torch.stack(rets)


def _solve_fused(env, T, nb_iter, x0s, kff0):
    N = x0s.shape[0]
    return cuda_elqr.cuda_elqr_solve(env, to_soa(kff0, N), x0s.T.contiguous(), nb_iter)


def make_elqr_solver_batched(env, nb_steps: int, nb_iter: int = 10, engine: str = "auto",
                             mesh=None, *, device="cuda", dtype=torch.float32):
    """Batch-of-problems eLQR: ``solve(x0s (N, dx), generator=None,
    kff_init=None) -> (ctl, xs (N, T+1, dx), us (N, T, du), trace (N,
    nb_iter+1))`` with the iteration semantics of :func:`make_elqr_solver`.
    ``engine`` is one of ``"scan"``, ``"cuda"``, ``"cuda-fused"`` or
    ``"auto"`` (see the module docstring); the kernel engines raise
    ``ValueError`` for an env the kernels do not take."""
    if mesh is not None:
        raise _not_ported_mesh("the batch mesh (mesh)")
    if engine != "auto" and engine not in ENGINES:
        raise ValueError(f"unknown engine {engine!r}")
    if engine in ("cuda", "cuda-fused"):
        cuda_elqr.check_env(env)
    T = nb_steps
    kw = dict(dtype=dtype, device=_resolve(device))
    dx, du = env.dm_state, env.dm_act

    def solve(x0s: Tensor, generator: torch.Generator | None = None,
              kff_init: Tensor | None = None):
        if x0s.device != kw["device"] or x0s.dtype != kw["dtype"]:
            raise ValueError(f"x0s is {x0s.dtype} on {x0s.device}; this solver was built for "
                             f"{kw['dtype']} on {kw['device']}")
        N = x0s.shape[0]
        kff0 = (_draw_kff(N, T, du, generator, kw) if kff_init is None
                else kff_init.to(**kw))
        use = pick_engine(env, N, kw["device"]) if engine == "auto" else engine
        if use == "scan":
            return _solve_scan(env, T, nb_iter, x0s, kff0)
        run = _solve_fused if use == "cuda-fused" else _solve_cuda
        K, kff, xs, us, rets = run(env, T, nb_iter, x0s, kff0)
        ctl = LinearPolicy(K=from_soa(K, N, (du, dx)), kff=from_soa(kff, N, (du,)))
        return ctl, from_soa(xs, N, (dx,)), from_soa(us, N, (du,)), rets.T

    return solve


def make_elqr_solver(env, nb_steps: int, nb_iter: int = 10, *, device="cuda",
                     dtype=torch.float32):
    """Single-problem eLQR: ``solve(x0 (dx,), generator=None, kff_init=None)
    -> (ctl, xs (T+1, dx), us (T, du), trace (nb_iter+1,))``, the host
    class's iteration semantics and initial controller (kff_init ``(T, du)``
    or N(0, 1) from ``generator``), as a batch of one on the scan engine."""
    batched = make_elqr_solver_batched(env, nb_steps, nb_iter, engine="scan", device=device,
                                       dtype=dtype)

    def solve(x0: Tensor, generator: torch.Generator | None = None,
              kff_init: Tensor | None = None):
        ctl, xs, us, trace = batched(x0[None], generator,
                                     None if kff_init is None else kff_init[None])
        return LinearPolicy(K=ctl.K[0], kff=ctl.kff[0]), xs[0], us[0], trace[0]

    return solve
