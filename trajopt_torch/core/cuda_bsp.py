"""Single-launch BSP-iLQR on the card: the whole solve (K9) and the whole
belief-MPC episode (K10), ``csrc/bsp.cu``.

Counterpart of ``trajopt_tpu/core/pallas_bsp.py`` (``pallas_bsp_solve``,
``pallas_bsp_episode``).  A solve is ``nb_iter`` iterations of: the belief
expansion at every step, the λ-escalated backward, the α-grid belief
rollouts and accept/reject, with ``parallel/bsp.make_bsp_solver``'s
semantics (dense value form).  The λ while-loop is a deterministic ladder
given (λ, Δλ), so all ``_NL`` trials run at once and the trial the loop would
stop at is taken.  An episode is K9's solve at every control step from the
current belief, the noisy true step and observation from handed-in standard
normals (``mean + chol(cov) ε``) and a Joseph-form EKF update.

Batch 1, as on the TPU: one launch, one thread block.  The plain versions
(:func:`bsp_solve_plain`, :func:`bsp_episode_plain`) are batched tensor code:
the λ trials are a batch axis, the α candidates another, time a batch axis
of the expansion.  CUDA tensors launch the kernels; CPU tensors run the plain
versions.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import torch
from torch import Tensor

from ..kernels import _build
from ..solvers.common import DEFAULT_ALPHAS

MAX_STEPS = 128  # T + 1, nb_iter and nb_steps + 1 (the TPU kernels' lane count)
MAX_ALPHAS = 128
NL = 16          # trials of the λ ladder (csrc/bsp.cu NL; pallas_bsp.py _NL)


@dataclass(frozen=True)
class BSPConfig:
    """A solve's static configuration (``make_bsp_solver``'s arguments)."""

    T: int
    nb_iter: int
    alphas: tuple = DEFAULT_ALPHAS
    lmbda: float = 1.0
    min_lmbda: float = 1e-6
    max_lmbda: float = 1e6
    mult_lmbda: float = 1.6
    tolfun: float = 1e-8
    tolgrad: float = 1e-6
    min_imp: float = 0.0
    reg: int = 1


def bsp_config(env, nb_steps: int, nb_iter: int, nb_episode_steps: int = 0, **kw) -> BSPConfig:
    """The configuration, checked against the kernels' limits
    (pallas_bsp.py:871): T+1, ``nb_iter`` and ``nb_episode_steps``+1 at most
    128, and an env with the kernels' device functions."""
    alphas = tuple(float(x) for x in kw.pop("alphas", DEFAULT_ALPHAS))
    cfg = BSPConfig(T=nb_steps, nb_iter=nb_iter, alphas=alphas, **kw)
    if not env.supports_belief_tiles:
        raise NotImplementedError(
            f"{type(env).__name__} has no device functions for the BSP kernels K9/K10 yet "
            "(ROADMAP.md queue 1, row 11e)")
    if cfg.T + 1 > MAX_STEPS or cfg.nb_iter > MAX_STEPS or nb_episode_steps + 1 > MAX_STEPS:
        raise ValueError("horizon/iterations/steps must fit in 128 lanes")
    if len(cfg.alphas) > MAX_ALPHAS:
        raise ValueError(f"at most {MAX_ALPHAS} line-search candidates")
    if cfg.reg not in (1, 2):
        raise ValueError(f"reg must be 1 or 2, got {cfg.reg}")
    return cfg


def plain_solver(env, cfg: BSPConfig, device, dtype):
    """``parallel/bsp``'s batched solver with the λ ladder as a batch axis
    (engine ``"ladder"``) and the single-problem λ rule, the solver of K9's
    plain version; it has ``init`` and ``iteration`` like the others."""
    from ..parallel.bsp import _make_solver

    kw = {k: v for k, v in cfg.__dict__.items() if k not in ("T", "nb_iter")}
    return _make_solver(env, cfg.T, cfg.nb_iter, engine="ladder", single=True, device=device,
                        dtype=dtype, **kw)


# --------------------------------------------------------------------------------------
# Plain versions
# --------------------------------------------------------------------------------------


def bsp_solve_plain(env, cfg: BSPConfig, mu0: Tensor, sigma0: Tensor):
    """K9's plain version: ``(BSPState, trace (nb_iter,))`` of one solve from
    the belief (``mu0 (b,)``, ``sigma0 (b, b)``), with zero initial kff."""
    from ..parallel.bsp import BSPState

    state, trace = plain_solver(env, cfg, mu0.device, mu0.dtype)(mu0[None], sigma0[None])
    return BSPState(*(x[0] for x in state)), trace[:, 0]


def bsp_episode_plain(env, cfg: BSPConfig, x0: Tensor, eps0: Tensor, eps_dyn: Tensor,
                      eps_obs: Tensor):
    """K10's plain version: the episode of ``parallel/bsp.run_bsp_episode``
    with K9's plain solve as the replan."""
    from ..parallel.bsp import run_bsp_episode

    def solve(mu, sigma):
        return bsp_solve_plain(env, cfg, mu, sigma)

    return run_bsp_episode(env, solve, x0, (eps0, eps_dyn, eps_obs))


# --------------------------------------------------------------------------------------
# Kernel wrappers
# --------------------------------------------------------------------------------------


class _Params(ctypes.Structure):
    """``BSPParams`` of csrc/bsp.cu, passed by value."""

    _fields_ = [
        ("dt", ctypes.c_double), ("xmax", ctypes.c_double * 4), ("umax", ctypes.c_double * 2),
        ("goal", ctypes.c_double * 4), ("mu_w", ctypes.c_double * 4),
        ("sigma_w", ctypes.c_double * 4), ("act_w", ctypes.c_double * 2),
        ("dyn_sigma", ctypes.c_double), ("obs_sigma", ctypes.c_double),
        ("mu_init", ctypes.c_double * 4), ("sig_init", ctypes.c_double * 16),
        ("lmbda", ctypes.c_double), ("min_lmbda", ctypes.c_double),
        ("max_lmbda", ctypes.c_double), ("mult_lmbda", ctypes.c_double),
        ("tolfun", ctypes.c_double), ("tolgrad", ctypes.c_double), ("min_imp", ctypes.c_double),
        ("alphas", ctypes.c_double * MAX_ALPHAS),
        ("T", ctypes.c_int), ("nb_iter", ctypes.c_int), ("nA", ctypes.c_int), ("reg", ctypes.c_int),
    ]


@functools.lru_cache(maxsize=None)
def _params(env, cfg: BSPConfig) -> _Params:
    """The kernels' parameters, made once per env and configuration (no
    copy to the card per call)."""
    p = _Params()
    p.dt = env.dt
    for name in ("xmax", "umax", "goal", "mu_w", "sigma_w", "act_w"):
        getattr(p, name)[:len(getattr(env, name))] = getattr(env, name)
    p.dyn_sigma, p.obs_sigma = env.dyn_sigma_scale, env.obs_sigma_scale
    mu0, sigma0 = env.init()
    p.mu_init[:mu0.numel()] = mu0.tolist()
    p.sig_init[:sigma0.numel()] = sigma0.flatten().tolist()
    for name in ("lmbda", "min_lmbda", "max_lmbda", "mult_lmbda", "tolfun", "tolgrad", "min_imp"):
        setattr(p, name, getattr(cfg, name))
    p.alphas[:len(cfg.alphas)] = cfg.alphas
    p.T, p.nb_iter, p.nA, p.reg = cfg.T, cfg.nb_iter, len(cfg.alphas), cfg.reg
    return p


_P, _I = ctypes.c_void_p, ctypes.c_int


def _scratch_size(env, cfg: BSPConfig) -> int:
    """Scalars of the kernels' global scratch (csrc/bsp.cu ``Scratch``)."""
    b, a = env.belief_dim, env.act_dim
    bb, T, nA = b * b, cfg.T, len(cfg.alphas)
    expansion = (T + 1) * (b * b + b + a * a + a + b * a + bb
                           + b * b + b * a + 2 * bb * b + 2 * bb * bb + 2 * bb * a)
    trials = NL * T * (a * b + a)
    rollouts = nA * (T + 1) * (b + bb + a)
    state = (T + 1) * (b + bb) + T * (a + a * b + a)
    return expansion + trials + rollouts + state



def _call(name: str, env, cfg: BSPConfig, ins, outs, *ints):
    dev = outs[0].device
    code = _build.cuda_operands(name, *ins, *outs)
    scratch = torch.empty(_scratch_size(env, cfg), dtype=outs[0].dtype, device=dev)
    entry = "trajopt_bsp_solve" if name.startswith("K9") else "trajopt_bsp_episode"
    fn = _build.function("bsp.cu", entry,
                         [_I, _Params] + [_P] * (len(ins) + len(outs) + 1) + [_I] * len(ints)
                         + [_P])
    with torch.cuda.device(dev):
        rc = fn(code, _params(env, cfg), *(t.data_ptr() for t in (*ins, *outs, scratch)), *ints,
                torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, name)


def cuda_bsp_solve(env, cfg: BSPConfig, mu0: Tensor, sigma0: Tensor):
    """K9: one BSP-iLQR solve from the belief (``mu0 (b,)``, ``sigma0 (b,
    b)``) → ``(BSPState, trace (nb_iter,))``.  CUDA tensors launch the
    kernel; CPU tensors run :func:`bsp_solve_plain`."""
    if mu0.device.type == "cpu":
        return bsp_solve_plain(env, cfg, mu0, sigma0)
    from ..parallel.bsp import BSPState

    b, a, T = env.belief_dim, env.act_dim, cfg.T
    kw = dict(dtype=mu0.dtype, device=mu0.device)
    outs = [torch.empty(T + 1, b, **kw), torch.empty(T + 1, b, b, **kw), torch.empty(T, a, **kw),
            torch.empty(T, a, b, **kw), torch.empty(T, a, **kw), torch.empty(4, **kw),
            torch.empty(cfg.nb_iter, **kw)]
    _call("K9 bsp_solve", env, cfg, [mu0.contiguous(), sigma0.contiguous()], outs)
    cuda_bsp_solve.launches += 1
    misc = outs[5]
    return BSPState(*outs[:5], misc[0], misc[1], misc[2], misc[3] > 0.5), outs[6]


def cuda_bsp_episode(env, cfg: BSPConfig, x0: Tensor, eps0: Tensor, eps_dyn: Tensor,
                     eps_obs: Tensor):
    """K10: one belief-MPC episode of ``eps_dyn.shape[0]`` control steps from
    the true state ``x0`` → (states (S+1, dx), belief means (S+1, b), belief
    covariances (S+1, b, b), actions (S, a), belief costs (S,)).  CUDA
    tensors launch the kernel; CPU tensors run :func:`bsp_episode_plain`."""
    if x0.device.type == "cpu":
        return bsp_episode_plain(env, cfg, x0, eps0, eps_dyn, eps_obs)
    S = eps_dyn.shape[0]
    b, a = env.belief_dim, env.act_dim
    kw = dict(dtype=x0.dtype, device=x0.device)
    outs = [torch.empty(S + 1, env.state_dim, **kw), torch.empty(S + 1, b, **kw),
            torch.empty(S + 1, b, b, **kw), torch.empty(S, a, **kw), torch.empty(S, **kw)]
    ins = [x0, eps0, eps_dyn, eps_obs]
    _call("K10 bsp_episode", env, cfg, [t.contiguous() for t in ins], outs, S)
    cuda_bsp_episode.launches += 1
    return tuple(outs)


cuda_bsp_solve.launches = 0
cuda_bsp_episode.launches = 0


def make_cuda_bsp_solve(env, nb_steps: int, nb_iter: int = 25, **kw):
    """``solve(mu0 (b,), sigma0 (b, b)) -> (BSPState, trace)``: one launch of
    K9 per solve (``pallas_bsp_solve``'s counterpart), with
    ``make_bsp_solver``'s keyword arguments."""
    cfg = bsp_config(env, nb_steps, nb_iter, **kw)

    def solve(mu0: Tensor, sigma0: Tensor):
        return cuda_bsp_solve(env, cfg, mu0, sigma0)

    return solve


def make_cuda_bsp_episode(env, horizon: int, nb_steps: int, nb_iter: int = 25, **kw):
    """``run(x0, eps0, eps_dyn, eps_obs) -> (xs, mus, sigmas, us, cs)``: one
    launch of K10 per episode (``pallas_bsp_episode``'s counterpart)."""
    cfg = bsp_config(env, horizon, nb_iter, nb_steps, **kw)

    def run(x0: Tensor, eps0: Tensor, eps_dyn: Tensor, eps_obs: Tensor):
        if eps_dyn.shape[0] != nb_steps:
            raise ValueError(f"{eps_dyn.shape[0]} steps of normals for a {nb_steps}-step episode")
        return cuda_bsp_episode(env, cfg, x0, eps0, eps_dyn, eps_obs)

    return run
