"""Extended-LQR sweeps and the whole eLQR solve as CUDA kernels (K11–K14).

Counterpart of ``trajopt_tpu/core/pallas_elqr.py``:

* :func:`cuda_elqr_forward` (K11, ``_forward_kernel``): the cost-to-come
  sweep, linearizing the inverse dynamics at each step's next state;
* :func:`cuda_elqr_backward` (K12, ``_backward_kernel``): the terminal step,
  then the cost-to-go sweep in reverse time, linearizing the dynamics at each
  step's previous state;
* :func:`cuda_elqr_rollout` (K13, ``_rollout_kernel``): the evaluation
  rollout's return, and with ``store=True`` its states and actions;
* :func:`cuda_elqr_solve` (K14, ``_solve_kernel``): ``nb_iter`` iterations of
  the three and the final stored rollout in one launch.

Operands are structure-of-arrays streams with time leading, ``(rows, entries,
N)`` with no padding: the controllers ``K (T, du·dx, N)``, ``kff (T, du, N)``,
the come and go values ``V (T+1, dx·dx, N)``, ``v (T+1, dx, N)``, ``v0 (T+1,
1, N)`` with their boundary rows in place (comeV₀ = 1e-16·I at row 0, the
terminal go value at row T), states ``(dx, N)``.  Each step re-chooses the
state as the minimizer of the summed come and go quadratics.

CUDA tensors launch ``csrc/elqr.cu``; CPU tensors run the plain versions
below: lane-major PyTorch on ``(N,)`` planes in the kernels' order of
operations, with the Jacobians as forward-mode columns of the tile physics
(``tile_dynamics`` and :func:`tile_inverse_dynamics`, run on dual numbers
with the kernels' formulas) and JAX's ½ slope at a clip bound.  The env must have the kernels' device functions
(``cuda_rollout.env_kernel_args``), the base feature-goal cost and no slew
rate.
"""

from __future__ import annotations

import ctypes

import torch
from torch import Tensor

from ..kernels import _build
from .cuda_rollout import env_kernel_args, tile_clip_act, tile_clip_state, tile_dynamics
from .pscan_lqr import _gj_inv, _lmm, _lmv, _lt

# --------------------------------------------------------------------------------------
# Tile physics and the closed-form quadratization on (N,) planes
# --------------------------------------------------------------------------------------


def _rk4_parts(env, x, u, sign: float):
    """One RK4 step over ``_ode_parts`` without clips; ``sign`` −1 takes the
    backward-sign step of ``inverse_dynamics``."""
    dt = float(env.dt)
    half, full, sixth = sign * (0.5 * dt), sign * dt, sign * (dt / 6.0)
    f = env._ode_parts
    n = len(x)
    k1 = f(x, u)
    k2 = f([x[i] + half * k1[i] for i in range(n)], u)
    k3 = f([x[i] + half * k2[i] for i in range(n)], u)
    k4 = f([x[i] + full * k3[i] for i in range(n)], u)
    return [x[i] + sixth * (k1[i] + 2.0 * k2[i] + 2.0 * k3[i] + k4[i]) for i in range(n)]


def tile_inverse_dynamics(env, x, u):
    """``env.inverse_dynamics`` on parts: clip the action, backward-sign RK4,
    clip the state."""
    return tile_clip_state(env, _rk4_parts(env, x, tile_clip_act(env, u), -1.0))


def _clip_slope(v: Tensor, bound: float) -> Tensor:
    """``jnp.clip``'s derivative at ``v``: 1 inside ±bound, ½ at a bound, 0
    outside."""
    a = v.abs()
    return torch.where(a < bound, 1.0, torch.where(a == bound, 0.5, 0.0)).to(v.dtype)


class _Dual:
    """A value ``v (N,)`` and its tangents ``d (n, N)``: forward-mode
    arithmetic with the formulas of ``csrc/dual.cuh`` (a quotient's tangent
    times the divisor's reciprocal), for the plain versions' Jacobians.  It
    covers the operations of Cartpole's and Pendulum's ODEs and features."""

    def __init__(self, v: Tensor, d: Tensor):
        self.v, self.d = v, d

    def __add__(self, b):
        if isinstance(b, _Dual):
            return _Dual(self.v + b.v, self.d + b.d)
        return _Dual(self.v + b, self.d)

    __radd__ = __add__

    def __sub__(self, b):
        if isinstance(b, _Dual):
            return _Dual(self.v - b.v, self.d - b.d)
        return _Dual(self.v - b, self.d)

    def __rsub__(self, b):
        return _Dual(b - self.v, -self.d)

    def __neg__(self):
        return _Dual(-self.v, -self.d)

    def __mul__(self, b):
        if isinstance(b, _Dual):
            return _Dual(self.v * b.v, self.d * b.v + self.v * b.d)
        return _Dual(self.v * b, self.d * b)

    __rmul__ = __mul__

    def __truediv__(self, b):
        if isinstance(b, _Dual):
            r = self.v / b.v
            return _Dual(r, (self.d - r * b.d) * (1.0 / b.v))
        return _Dual(self.v / b, self.d / b)

    def __pow__(self, k):
        if k != 2:
            return NotImplemented
        return self * self

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        (a,) = args
        if func is torch.sin:
            return _Dual(torch.sin(a.v), a.d * torch.cos(a.v))
        if func is torch.cos:
            return _Dual(torch.cos(a.v), a.d * -torch.sin(a.v))
        return NotImplemented


def _jac_columns(f, primals):
    """``J[i][k] = ∂f_i/∂p_k`` at the planes ``primals (N,)``: ``f`` on
    duals seeded with the unit tangents, as the kernels seed theirs."""
    n = len(primals)
    eye = torch.eye(n, dtype=primals[0].dtype, device=primals[0].device)
    duals = [_Dual(p, eye[:, k, None].expand(n, *p.shape)) for k, p in enumerate(primals)]
    return [[o.d[k] for k in range(n)] for o in f(*duals)]


def _lin_about(env, x, u, sign: float):
    """A, B, c of ``f(ξ, ν) ≈ Aξ + Bν + c`` about (x, u), f the dynamics
    (``sign`` 1) or the inverse dynamics (−1): the forward-mode columns of
    the unclipped RK4 at the clipped action, scaled by the clips' slopes (the
    chain rule a dual number carries through the clips), and c = (f − Ax) −
    Bu."""
    dx, du = len(x), len(u)
    uc = tile_clip_act(env, u)
    su = [_clip_slope(u[j], float(env.umax[j])) for j in range(du)]

    def raw(*p):
        return tuple(_rk4_parts(env, list(p[:dx]), list(p[dx:]), sign))

    J = _jac_columns(raw, list(x) + uc)
    f_raw = raw(*x, *uc)
    f0 = tile_clip_state(env, list(f_raw))
    sx = [_clip_slope(f_raw[i], float(env.xmax[i])) for i in range(dx)]
    A = [[sx[i] * J[i][k] for k in range(dx)] for i in range(dx)]
    B = [[sx[i] * (J[i][dx + j] * su[j]) for j in range(du)] for i in range(dx)]
    c = [f0[i] - sum(A[i][k] * x[k] for k in range(dx)) - sum(B[i][j] * u[j] for j in range(du))
         for i in range(dx)]
    return A, B, c


def _quad_cost(env, x, u):
    """The closed-form eLQR quadratization at (x, u) with u_last = 0, a = 1
    (``pallas_elqr._tile_quad_cost``): Cxx = JᵀGJ, cx = 2JᵀG(z₀−g) − 2Cxx·x
    and c0, with Cuu = diag(uw) and Cxu = cu = 0 left implicit."""
    dx, du = len(x), len(u)
    uw = tuple(float(v) for v in env.uw)
    g = tuple(float(v) for v in env.g)
    gw = tuple(float(v) for v in env.gw)
    y = list(env._periodic_parts(x))
    z0 = env.features_parts(y)
    nz = len(z0)
    J = _jac_columns(lambda *yy: tuple(env.features_parts(list(yy))), y)
    Cxx = [[sum(gw[k] * J[k][i] * J[k][j] for k in range(nz)) for j in range(dx)]
           for i in range(dx)]
    gx = [2.0 * sum(gw[k] * (z0[k] - g[k]) * J[k][i] for k in range(nz)) for i in range(dx)]
    cx = [gx[i] - 2.0 * sum(Cxx[i][j] * x[j] for j in range(dx)) for i in range(dx)]
    uCu = sum(uw[j] * u[j] * u[j] for j in range(du))
    cost = uCu + sum(gw[k] * (z0[k] - g[k]) ** 2 for k in range(nz))
    xCx = sum(x[i] * Cxx[i][j] * x[j] for i in range(dx) for j in range(dx))
    c0 = cost - xCx - uCu - sum(cx[i] * x[i] for i in range(dx))
    return Cxx, cx, c0


def _stage_cost(env, x, u):
    """The eLQR stage cost on the raw action (u_last = 0, a = 1)."""
    uw = tuple(float(v) for v in env.uw)
    g = tuple(float(v) for v in env.g)
    gw = tuple(float(v) for v in env.gw)
    z = env.features_parts(env._periodic_parts(x))
    return (sum(uw[j] * u[j] * u[j] for j in range(len(u)))
            + sum(gw[k] * (z[k] - g[k]) ** 2 for k in range(len(z))))


def _sym(M):
    n = len(M)
    return [[0.5 * (M[i][j] + M[j][i]) for j in range(n)] for i in range(n)]


def _cuu(env, like):
    du = env.dm_act
    return [[torch.full_like(like, float(env.uw[i])) if i == j else torch.zeros_like(like)
             for j in range(du)] for i in range(du)]


def _rechoose(Va, Vb, va, vb):
    dx = len(va)
    S = [[Va[a][b] + Vb[a][b] for b in range(dx)] for a in range(dx)]
    r = [va[a] + vb[a] for a in range(dx)]
    return [-e for e in _lmv(_gj_inv(S), r)]


def _gains_and_value(Qxx, Quu, Qux, qx, qu, q0):
    dx, du = len(qx), len(qu)
    Qiu = _gj_inv(Quu)
    K = [[-e for e in row] for row in _lmm(Qiu, Qux)]
    kff = [-e for e in _lmv(Qiu, qu)]
    V = _sym([[Qxx[a][b] + sum(Qux[k][a] * K[k][b] for k in range(du)) for b in range(dx)]
              for a in range(dx)])
    v = [qx[a] + sum(Qux[k][a] * kff[k] for k in range(du)) for a in range(dx)]
    v0 = q0 + 0.5 * sum(qu[k] * kff[k] for k in range(du))
    return K, kff, V, v, v0


def forward_step(env, K, kff, goV_n, gov_n, x, comeV, comev, comev0):
    """One cost-to-come step (``pallas_elqr._forward_step``) on planes.
    Returns ``(iK, ikff, comeV_n, comev_n, comev0_n, x_new)``."""
    dx, du = len(x), len(kff)
    u = [kff[j] + sum(K[j][c] * x[c] for c in range(dx)) for j in range(du)]
    xn = tile_dynamics(env, x, u)
    A, B, c = _lin_about(env, xn, u, -1.0)
    Cxx, cx, c0 = _quad_cost(env, x, u)
    Cuu = _cuu(env, x[0])

    M = [[Cxx[a][b] + comeV[a][b] for b in range(dx)] for a in range(dx)]
    Qxx = _lmm(_lmm(_lt(A), M), A)
    BtM = _lmm(_lt(B), M)
    Quu = [[sum(BtM[a][k] * B[k][b] for k in range(dx)) + Cuu[a][b] for b in range(du)]
           for a in range(du)]
    Qux = _lmm(BtM, A)
    Mc = _lmv(M, c)
    vec = [Mc[k] + cx[k] + comev[k] for k in range(dx)]
    qx = _lmv(_lt(A), vec)
    qu = _lmv(_lt(B), vec)
    q0 = (0.5 * sum(c[k] * Mc[k] for k in range(dx))
          + sum(c[k] * (cx[k] + comev[k]) for k in range(dx)) + c0 + comev0)
    iK, ikff, V, v, v0 = _gains_and_value(Qxx, Quu, Qux, qx, qu, q0)
    return iK, ikff, V, v, v0, _rechoose(goV_n, V, gov_n, v)


def backward_step(env, iK, ikff, comeV_t, comev_t, x, goV_n, gov_n, gov0_n):
    """One cost-to-go step (``pallas_elqr._backward_step``) on planes.
    Returns ``(K, kff, goV, gov, gov0, x_new)``."""
    dx, du = len(x), len(ikff)
    u = [ikff[j] + sum(iK[j][c] * x[c] for c in range(dx)) for j in range(du)]
    xp = tile_inverse_dynamics(env, x, u)
    A, B, c = _lin_about(env, xp, u, 1.0)
    Cxx, cx, c0 = _quad_cost(env, xp, u)
    Cuu = _cuu(env, x[0])

    AtV = _lmm(_lt(A), goV_n)
    Qxx = [[Cxx[a][b] + sum(AtV[a][k] * A[k][b] for k in range(dx)) for b in range(dx)]
           for a in range(dx)]
    BtV = _lmm(_lt(B), goV_n)
    Quu = [[Cuu[a][b] + sum(BtV[a][k] * B[k][b] for k in range(dx)) for b in range(du)]
           for a in range(du)]
    Qux = _lmm(BtV, A)
    Vc = _lmv(goV_n, c)
    vec = [Vc[k] + gov_n[k] for k in range(dx)]
    qx = [cx[a] + sum(A[k][a] * vec[k] for k in range(dx)) for a in range(dx)]
    qu = [sum(B[k][a] * vec[k] for k in range(dx)) for a in range(du)]
    q0 = (c0 + gov0_n + 0.5 * sum(c[k] * Vc[k] for k in range(dx))
          + sum(c[k] * gov_n[k] for k in range(dx)))
    K, kff, V, v, v0 = _gains_and_value(Qxx, Quu, Qux, qx, qu, q0)
    return K, kff, V, v, v0, _rechoose(V, comeV_t, v, comev_t)


def terminal_step(env, x, comeV_T, comev_T):
    """The terminal go value quadratized at (x, 0) and x re-chosen against
    the come value at T.  Returns ``(goV_T, gov_T, gov0_T, x_new)``."""
    zeros = [torch.zeros_like(x[0]) for _ in range(env.dm_act)]
    V, v, v0 = _quad_cost(env, x, zeros)
    return V, v, v0, _rechoose(V, comeV_T, v, comev_T)


# --------------------------------------------------------------------------------------
# Plain versions on the kernels' streams
# --------------------------------------------------------------------------------------


def _mat(row: Tensor, n: int, m: int):
    return [[row[i * m + j] for j in range(m)] for i in range(n)]


def _flat(M):
    return [e for r in M for e in r]


def _rows(rows) -> Tensor:
    """A list of per-row lists of planes → a ``(rows, entries, N)`` stream."""
    return torch.stack([torch.stack(r) for r in rows])


def _initial_come(dx: int, like: Tensor):
    zero = torch.zeros_like(like)
    V = [[torch.full_like(like, 1e-16) if a == b else zero for b in range(dx)]
         for a in range(dx)]
    return V, [zero] * dx, zero


def _forward_sweep(env, K, kff, goV, gov, x):
    T, du = kff.shape[0], kff.shape[1]
    dx = len(x)
    V, v, v0 = _initial_come(dx, x[0])
    outs = {"iK": [], "ikff": [], "V": [_flat(V)], "v": [v], "v0": [[v0]]}
    for t in range(T):
        iK, ikff, V, v, v0, x = forward_step(env, _mat(K[t], du, dx), list(kff[t]),
                                             _mat(goV[t + 1], dx, dx), list(gov[t + 1]),
                                             x, V, v, v0)
        for key, val in (("iK", _flat(iK)), ("ikff", ikff), ("V", _flat(V)), ("v", v),
                         ("v0", [v0])):
            outs[key].append(val)
    return outs, x


def _backward_sweep(env, iK, ikff, comeV, comev, x):
    T, du = ikff.shape[0], ikff.shape[1]
    dx = len(x)
    V, v, v0, x = terminal_step(env, x, _mat(comeV[T], dx, dx), list(comev[T]))
    outs = {"K": [], "kff": [], "V": [_flat(V)], "v": [v], "v0": [[v0]]}
    for t in range(T - 1, -1, -1):
        K, kff, V, v, v0, x = backward_step(env, _mat(iK[t], du, dx), list(ikff[t]),
                                            _mat(comeV[t], dx, dx), list(comev[t]), x,
                                            V, v, v0)
        for key, val in (("K", _flat(K)), ("kff", kff), ("V", _flat(V)), ("v", v),
                         ("v0", [v0])):
            outs[key].append(val)
    for key in outs:
        outs[key].reverse()
    return outs, x


def elqr_forward_plain(env, K, kff, goV, gov, x0):
    """K11's plain version."""
    outs, x = _forward_sweep(env, K, kff, goV, gov, list(x0))
    return (_rows(outs["iK"]), _rows(outs["ikff"]), _rows(outs["V"]), _rows(outs["v"]),
            _rows(outs["v0"]), torch.stack(x))


def elqr_backward_plain(env, iK, ikff, comeV, comev, x_in):
    """K12's plain version."""
    outs, x = _backward_sweep(env, iK, ikff, comeV, comev, list(x_in))
    return (_rows(outs["K"]), _rows(outs["kff"]), _rows(outs["V"]), _rows(outs["v"]),
            _rows(outs["v0"]), torch.stack(x))


def elqr_rollout_plain(env, K, kff, x0, store: bool = False):
    """K13's plain version: the return ``(N,)``, and with ``store`` also the
    states ``(T+1, dx, N)`` and actions ``(T, du, N)``."""
    T, du = kff.shape[0], kff.shape[1]
    x = list(x0)
    dx = len(x)
    ret = torch.zeros_like(x[0])
    xs, us = [], []
    for t in range(T):
        Kt = _mat(K[t], du, dx)
        u = [kff[t, j] + sum(Kt[j][c] * x[c] for c in range(dx)) for j in range(du)]
        ret = ret + _stage_cost(env, x, u)
        xs.append(x)
        us.append(u)
        x = tile_dynamics(env, x, u)
    ret = ret + _stage_cost(env, x, [torch.zeros_like(ret)] * du)
    if not store:
        return ret
    return ret, _rows(xs + [x]), _rows(us)


def elqr_solve_plain(env, kff0, x0, nb_iter: int):
    """K14's plain version: the plain sweeps in the fused solve's order.
    Returns ``(K (T, du·dx, N), kff (T, du, N), xs (T+1, dx, N), us (T, du,
    N), rets (nb_iter+1, N))``."""
    T, du, N = kff0.shape
    dx = x0.shape[0]
    K = torch.zeros(T, du * dx, N, dtype=kff0.dtype, device=kff0.device)
    kff = kff0
    goV = torch.zeros(T + 1, dx * dx, N, dtype=kff0.dtype, device=kff0.device)
    gov = torch.zeros(T + 1, dx, N, dtype=kff0.dtype, device=kff0.device)
    rets = [elqr_rollout_plain(env, K, kff, x0)]
    x = x0
    for _ in range(nb_iter):
        iK, ikff, comeV, comev, _, x = elqr_forward_plain(env, K, kff, goV, gov, x)
        K, kff, goV, gov, _, x = elqr_backward_plain(env, iK, ikff, comeV, comev, x)
        rets.append(elqr_rollout_plain(env, K, kff, x0))
    _, xs, us = elqr_rollout_plain(env, K, kff, x0, store=True)
    return K, kff, xs, us, torch.stack(rets)


# --------------------------------------------------------------------------------------
# Kernel wrappers
# --------------------------------------------------------------------------------------

_P, _I = ctypes.c_void_p, ctypes.c_int
_SWEEP_ARGTYPES = [_I, _I, _P] + [_P] * 11 + [_I, _I, _P]
_ROLLOUT_ARGTYPES = [_I, _I, _P] + [_P] * 6 + [_I, _I, _P]
_SOLVE_ARGTYPES = [_I, _I, _P] + [_P] * 8 + [_I, _I, _I, _P]


def check_env(env) -> None:
    """Raise ``ValueError`` unless the kernels (and their plain versions)
    take ``env``: the base feature-goal cost, no slew rate, and device
    functions in ``csrc/envs.cuh``."""
    if not getattr(env, "supports_tile_quadratization", False):
        raise ValueError(
            "the eLQR kernels need a tile-protocol env with the base feature-goal "
            f"cost (their quadratization is closed form); {type(env).__name__} does not qualify")
    if getattr(env, "slew_rate", False):
        raise ValueError("the eLQR kernels do not support slew-rate costs")
    env_kernel_args(env, env.dm_state, env.dm_act)


def _launch(name: str, entry: str, argtypes, env, tensors, ints, dx: int, du: int):
    kind, params = env_kernel_args(env, dx, du)
    present = [t for t in tensors if t is not None]
    code = _build.cuda_operands(name, *present)
    dev = present[0].device
    fn = _build.function("elqr.cu", entry, argtypes)
    with torch.cuda.device(dev):
        rc = fn(code, kind, ctypes.addressof(params),
                *(None if t is None else t.data_ptr() for t in tensors), *ints,
                torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, name)


def _empty(like: Tensor, *shape) -> Tensor:
    return torch.empty(*shape, dtype=like.dtype, device=like.device)


def cuda_elqr_forward(env, K, kff, goV, gov, x0):
    """K11: the forward (cost-to-come) sweep from the states ``x0 (dx, N)``
    under ``(K, kff)``, with the go values ``goV``/``gov (T+1, ·, N)`` (rows
    1 … T read).  Returns ``(iK, ikff, comeV, comev, comev0, x_out)``: the
    inverse controller (T rows), the come values (T+1 rows, row 0 the
    initial 1e-16·I) and the re-chosen final state."""
    check_env(env)
    if x0.device.type == "cpu":
        return elqr_forward_plain(env, K, kff, goV, gov, x0)
    T, du, N = kff.shape
    dx = x0.shape[0]
    outs = [_empty(x0, T, du * dx, N), _empty(x0, T, du, N), _empty(x0, T + 1, dx * dx, N),
            _empty(x0, T + 1, dx, N), _empty(x0, T + 1, 1, N), _empty(x0, dx, N)]
    _launch("K11 elqr_forward", "trajopt_elqr_forward", _SWEEP_ARGTYPES, env,
            [K, kff, goV, gov, x0, *outs], (T, N), dx, du)
    cuda_elqr_forward.launches += 1
    return tuple(outs)


def cuda_elqr_backward(env, iK, ikff, comeV, comev, x_in):
    """K12: the terminal step at ``x_in (dx, N)`` against the come value at
    row T, then the backward (cost-to-go) sweep under the inverse controller
    ``(iK, ikff)`` and the come values ``comeV``/``comev (T+1, ·, N)``.
    Returns ``(K, kff, goV, gov, gov0, x_out)``: the controller (T rows), the
    go values (T+1 rows, row T the terminal value) and the re-chosen initial
    state."""
    check_env(env)
    if x_in.device.type == "cpu":
        return elqr_backward_plain(env, iK, ikff, comeV, comev, x_in)
    T, du, N = ikff.shape
    dx = x_in.shape[0]
    outs = [_empty(x_in, T, du * dx, N), _empty(x_in, T, du, N),
            _empty(x_in, T + 1, dx * dx, N), _empty(x_in, T + 1, dx, N),
            _empty(x_in, T + 1, 1, N), _empty(x_in, dx, N)]
    _launch("K12 elqr_backward", "trajopt_elqr_backward", _SWEEP_ARGTYPES, env,
            [iK, ikff, comeV, comev, x_in, *outs], (T, N), dx, du)
    cuda_elqr_backward.launches += 1
    return tuple(outs)


def cuda_elqr_rollout(env, K, kff, x0, store: bool = False):
    """K13: the evaluation rollout of ``u = kff + Kx`` from ``x0 (dx, N)``.
    Returns the returns ``(N,)``; with ``store``, also the states ``(T+1,
    dx, N)`` and actions ``(T, du, N)``."""
    check_env(env)
    if x0.device.type == "cpu":
        return elqr_rollout_plain(env, K, kff, x0, store)
    T, du, N = kff.shape
    dx = x0.shape[0]
    ret = _empty(x0, N)
    xs = _empty(x0, T + 1, dx, N) if store else None
    us = _empty(x0, T, du, N) if store else None
    _launch("K13 elqr_rollout", "trajopt_elqr_rollout", _ROLLOUT_ARGTYPES, env,
            [K, kff, x0, ret, xs, us], (T, N), dx, du)
    cuda_elqr_rollout.launches += 1
    return (ret, xs, us) if store else ret


def cuda_elqr_solve(env, kff0, x0, nb_iter: int):
    """K14: the whole solve from ``kff0 (T, du, N)`` (K = 0) and ``x0 (dx,
    N)`` in one launch.  Returns ``(K (T, du·dx, N), kff (T, du, N), xs (T+1,
    dx, N), us (T, du, N), rets (nb_iter+1, N))``."""
    check_env(env)
    if x0.device.type == "cpu":
        return elqr_solve_plain(env, kff0, x0, nb_iter)
    T, du, N = kff0.shape
    dx = x0.shape[0]
    outs = [_empty(x0, T, du * dx, N), _empty(x0, T, du, N), _empty(x0, T + 1, dx, N),
            _empty(x0, T, du, N), _empty(x0, nb_iter + 1, N)]
    scratch = _empty(x0, N * (T * (du * dx + du) + 2 * (T + 1) * (dx * dx + dx)))
    _launch("K14 elqr_solve", "trajopt_elqr_solve", _SOLVE_ARGTYPES, env,
            [kff0, x0, *outs, scratch], (T, N, nb_iter), dx, du)
    cuda_elqr_solve.launches += 1
    return tuple(outs)


cuda_elqr_forward.launches = 0
cuda_elqr_backward.launches = 0
cuda_elqr_rollout.launches = 0
cuda_elqr_solve.launches = 0
