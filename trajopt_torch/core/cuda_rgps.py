"""The robust-GPS adversary fixed point as two CUDA kernels, K15 and K16
(``csrc/rgps.cu``).

Counterpart of ``trajopt_tpu/core/pallas_rgps.py``.  One trip of the damped
fixed point (rgps/mbrgps.py:386-408) is two launches over a batch of rows
(problem instances, or instances × β-candidates):

* K15, :func:`cuda_rgps_param_backward`: the adversary's optimal MatrixNormal
  per step (util.cpp:626-798): the joint (x, u, 1) moments under the carried
  marginal q, the Kronecker-lifted precision W = 2(agCpp + kron(Mz, V'))/(β+η),
  its unguarded p-dim Cholesky (p = dx(dx+du+1)), the entrywise identity
  sanitize, Σθ* = L⁻ᵀL⁻¹, μθ* = Σθ* w and the maximizer's value recursion
  through A + BK;
* K16, :func:`cuda_rgps_cubature_kl`: cubature propagation of the state
  marginal through the uncertain dynamics (util.cpp:232-361), the quadratic
  forms expanded around the central point instead of materializing the
  2·daug points, fused with the per-step KL(p‖q) and the geodesic damping
  q ← interp_KL(q, p; a).

Operands are structure-of-arrays streams with time leading, ``(T, entries,
N)`` (entry ``i·cols + j`` of a per-step block), written once per adversary
dual evaluation by :func:`pack_rgps_problem`; the carried marginal is ``(T+1,
dx, N)`` / ``(T+1, dx², N)`` (:func:`pack_rgps_xdist`).  Each kernel runs one
thread block per row and any N ≥ 1: K15 factors W in one warp, a row a lane,
and spreads the inverse, MᵀM and the value recursion over lanes while its
other warps stage the next steps; K16 spreads each step's quadratic forms,
point factors and reduction over lanes (``csrc/rgps.cu`` has the design).

Numerical contract (that of the TPU kernels): a non-PD pivot gives NaN,
unguarded, so a non-PD W yields NaN in the factor exactly where the scan
path (``core/cubature``) has it; the sanitized factor and the flag follow;
zero-weight cubature points inject NaN through 0·(row sum of their factor).

CUDA tensors launch the kernels; CPU tensors run the plain versions below,
which do the kernels' arithmetic in the kernels' order on per-row planes,
every sum in index order.  :func:`cuda_rgps_fixed_point` is the counterpart
of ``pallas_rgps_fixed_point``.
"""

from __future__ import annotations

import ctypes
import math

import torch
from torch import Tensor

from ..kernels import _build
from .cuda_gps import _dot, _logdet, _mm, _mm_tn, _mv, _mv_tn, _ordered_sum, _trace_prod
from .cuda_lqr import from_soa, to_soa
from .types import (
    GaussianSequence,
    LinearGaussianPolicy,
    MatrixNormalParams,
    QuadraticCost,
    matrices_from_vec,
    symmetrize,
)

A_INTERP = 0.1

# --------------------------------------------------------------------------------------
# Layout: batch-leading ↔ structure of arrays (T, entries, N)
# --------------------------------------------------------------------------------------


def pack_rgps_problem(cost: QuadraticCost, ctl: LinearGaussianPolicy, noise: Tensor,
                      agCpp: Tensor, agcp: Tensor, beta_plus_eta: Tensor, mu0: Tensor,
                      sigma0: Tensor) -> dict:
    """The operands of a fixed point but the carried marginal, in the
    kernels' layout, once per adversary dual evaluation.  Batch-leading
    inputs: ``cost`` stacks ``(N, T+1, …)``, ``ctl``/``noise`` ``(N, T, …)``,
    ``agCpp (N, T, p, p)``, ``agcp (N, T, p)``, ``beta_plus_eta (N,)``,
    ``mu0 (N, dx)``, ``sigma0 (N, dx, dx)``."""
    N, T = ctl.K.shape[:2]
    return dict(
        cxx=to_soa(cost.Cxx[:, :T], N), cx=to_soa(cost.cx[:, :T], N),
        cuu=to_soa(cost.Cuu[:, :T], N), cu=to_soa(cost.cu[:, :T], N),
        cxu=to_soa(cost.Cxu[:, :T], N), c0=to_soa(cost.c0[:, :T, None], N),
        cuun=to_soa(cost.Cuu[:, 1:T + 1], N),
        acpp=to_soa(agCpp, N), acp=to_soa(agcp, N), sigd=to_soa(noise, N),
        K=to_soa(ctl.K, N), kff=to_soa(ctl.kff, N), sigc=to_soa(ctl.sigma, N),
        bpe=beta_plus_eta.contiguous(),
        vT=to_soa(-cost.Cxx[:, T:], N)[0], vvT=to_soa(-cost.cx[:, T:], N)[0],
        v0T=to_soa(-cost.c0[:, T:, None], N)[0],
        mu0=to_soa(mu0[:, None], N)[0], sig0=to_soa(sigma0[:, None], N)[0],
    )


def pack_rgps_xdist(q: GaussianSequence) -> tuple[Tensor, Tensor]:
    """Carried marginal ``(N, T+1, …)`` → ``(T+1, dx, N)``, ``(T+1, dx², N)``."""
    N = q.mu.shape[0]
    return to_soa(q.mu, N), to_soa(q.sigma, N)


def unpack_rgps_xdist(qmu: Tensor, qsig: Tensor) -> GaussianSequence:
    N, dx = qmu.shape[-1], qmu.shape[1]
    return GaussianSequence(mu=from_soa(qmu, N, (dx,)), sigma=from_soa(qsig, N, (dx, dx)))


def unpack_rgps_param(muopt: Tensor, sigopt: Tensor) -> MatrixNormalParams:
    N, p = muopt.shape[-1], muopt.shape[1]
    return MatrixNormalParams(mu=from_soa(muopt, N, (p,)), sigma=from_soa(sigopt, N, (p, p)))


def _step_blocks(streams: dict, t: int, dx: int, du: int, names):
    """Step t of each named stream as ``(N, rows, cols)`` or ``(N, rows)``."""
    p = dx * (dx + du + 1)
    shapes = dict(cxx=(dx, dx), cuu=(du, du), cxu=(dx, du), cuun=(du, du), acpp=(p, p),
                  sigd=(dx, dx), K=(du, dx), sigc=(du, du), qsig=(dx, dx), sigopt=(p, p))
    N = streams["K"].shape[-1]
    return [streams[k][t].reshape(*shapes[k], N).permute(2, 0, 1) if k in shapes
            else streams[k][t].T for k in names]


# --------------------------------------------------------------------------------------
# Plain PyTorch versions: planes (N, rows, cols), every sum in index order
# --------------------------------------------------------------------------------------


def _eye(n: int, like: Tensor) -> Tensor:
    return torch.eye(n, dtype=like.dtype, device=like.device)


def _chol_nan(A: Tensor) -> tuple[Tensor, list[Tensor]]:
    """Left-looking Cholesky of ``A (N, n, n)`` with the contract of
    ``pallas_rgps._chol_nan``: NaN from a non-PD pivot on (sqrt of a negative
    number, unguarded), zeros above the diagonal.  Returns (L, 1/diag)."""
    n = A.shape[-1]
    L = torch.zeros_like(A)
    inv_d = []
    for j in range(n):
        col = A[:, j:, j]
        if j:
            acc = L[:, j:, 0] * L[:, j, 0, None]
            for k in range(1, j):
                acc = acc + L[:, j:, k] * L[:, j, k, None]
            col = col - acc
        d = torch.sqrt(col[:, 0])
        idv = 1.0 / d
        L[:, j, j] = d
        L[:, j + 1:, j] = col[:, 1:] * idv[:, None]
        inv_d.append(idv)
    return L, inv_d


def _inv_from_chol(L: Tensor, inv_d: list[Tensor]) -> Tensor:
    """(L Lᵀ)⁻¹ = MᵀM with M = L⁻¹ (``pallas_rgps._inv_from_chol``); the
    zeros of M above its diagonal lead each sum, so the order is the kernel's."""
    n = L.shape[-1]
    M = torch.zeros_like(L)
    for i in range(n):
        if i:
            acc = L[:, i, 0, None] * M[:, 0, :i]
            for k in range(1, i):
                acc = acc + L[:, i, k, None] * M[:, k, :i]
            M[:, i, :i] = -acc * inv_d[i][:, None]
        M[:, i, i] = inv_d[i]
    S = M[:, 0, :, None] * M[:, 0, None, :]
    for k in range(1, n):
        S = S + M[:, k, :, None] * M[:, k, None, :]
    return S


def _kron(M: Tensor, V: Tensor) -> Tensor:
    out = M[:, :, None, :, None] * V[:, None, :, None, :]
    return out.reshape(M.shape[0], M.shape[1] * V.shape[1], M.shape[2] * V.shape[2])


def _joint(mu_x, Sx, K, kff, Sc, dx, du, with_one):
    """Action moments and the (x, u[, 1]) covariance, both jittered by 1e-8."""
    mu_u = _mv(K, mu_x) + kff
    Su = symmetrize(Sc + _mm(_mm(K, Sx), K.mT)) + 1e-8 * _eye(du, Sc)
    cross = _mm(Sx, K.mT)
    n = dx + du + int(with_one)
    Sz = torch.zeros(Sx.shape[0], n, n, dtype=Sx.dtype, device=Sx.device)
    Sz[:, :dx, :dx] = Sx
    Sz[:, :dx, dx:dx + du] = cross
    Sz[:, dx:dx + du, :dx] = cross.mT
    Sz[:, dx:dx + du, dx:dx + du] = Su
    return mu_u, symmetrize(Sz) + 1e-8 * _eye(n, Sz)


def _param_step(Cxx, cx, Cuu, cu, Cxu, c0, Cuun, acpp, acp, sigd, K, kff, Sc, mu_x, Sx,
                inv_bpe, V, v, v0):
    """One step of K15 for every row (pallas_rgps.py:180-346)."""
    dx, du = Sx.shape[-1], kff.shape[-1]
    p1 = dx + du + 1
    p = dx * p1
    N = Sx.shape[0]
    mu_u, Sz = _joint(mu_x, Sx, K, kff, Sc, dx, du, True)
    mu_z = torch.cat([mu_x, mu_u, torch.ones_like(mu_x[:, :1])], dim=1)
    Mz = mu_z[:, :, None] * mu_z[:, None, :] + Sz

    X = 2.0 * (acpp + _kron(Mz, V)) * inv_bpe[:, None, None]
    W = 0.5 * (X + X.mT)
    w = -(acp + (mu_z[:, :, None] * v[:, None, :]).reshape(N, p)) * inv_bpe[:, None]

    L, _ = _chol_nan(W)
    finite = torch.isfinite(L)
    step_bad = ~finite.all(dim=2).all(dim=1)
    Ls = torch.where(finite, L, _eye(p, L))
    inv_ds = [1.0 / Ls[:, j, j] for j in range(p)]
    Sig = _inv_from_chol(Ls, inv_ds)
    mu_opt = _mv(Sig, w)

    A, B, cvec = matrices_from_vec(mu_opt, dx, du)
    S4 = Sig.reshape(N, p1, dx, p1, dx)
    P = None
    for ii in range(dx):
        for jj in range(dx):
            term = S4[:, :, ii, :, jj] * V[:, jj, ii, None, None]
            P = term if P is None else P + term
    Pxx, Puu, Pxu = P[:, :dx, :dx], P[:, dx:dx + du, dx:dx + du], P[:, :dx, dx:dx + du]
    px, pu, p00 = P[:, :dx, p1 - 1], P[:, dx:dx + du, p1 - 1], P[:, p1 - 1, p1 - 1]

    A_cl = A + _mm(B, K)
    c_cl = cvec + _mv(B, kff)
    blk = B.mT                                            # (du, dx): B's columns
    Vblk = _mm(blk, V.mT)
    mu_kv = tr_kv = None
    for a in range(du):
        for b in range(du):
            m = Sc[:, a, b] * _dot(blk[:, a], Vblk[:, b])
            tr = None
            for ii in range(dx):
                for jj in range(dx):
                    term = V[:, ii, jj] * Sig[:, (dx + b) * dx + jj, (dx + a) * dx + ii]
                    tr = term if tr is None else tr + term
            tr = Sc[:, a, b] * tr
            mu_kv = m if mu_kv is None else mu_kv + m
            tr_kv = tr if tr_kv is None else tr_kv + tr

    mCuuP, mCxuP = -Cuu + Puu, -Cxu + Pxu
    KtmC = _mm_tn(K, mCuuP)
    Vn = symmetrize((-Cxx + Pxx) + _mm(KtmC, K) + _mm_tn(A_cl, _mm(V, A_cl)) + 2.0 * _mm(mCxuP, K))
    Vc_cl = _mv(V, c_cl)
    mcu = -cu + 2.0 * pu
    vn = ((-cx + 2.0 * px) + 2.0 * _mv(KtmC, kff) + 2.0 * _mv(mCxuP, kff) + _mv_tn(K, mcu)
          + 2.0 * _mv_tn(A_cl, Vc_cl) + _mv_tn(A_cl, v))
    v0n = ((-c0 + p00) + _dot(kff, _mv(mCuuP, kff)) + _dot(kff, mcu) - _trace_prod(Cuun, Sc)
           + v0 + _trace_prod(V, sigd) + mu_kv + tr_kv + _dot(c_cl, Vc_cl) + _dot(c_cl, v))
    return mu_opt, Sig, Vn, vn, v0n, step_bad


def param_backward_plain(packed: dict, qmu: Tensor, qsig: Tensor):
    """K15's plain version, with the outputs of :func:`cuda_rgps_param_backward`."""
    T, dx, N = packed["cx"].shape
    du = packed["cu"].shape[1]
    p = dx * (dx + du + 1)
    V = packed["vT"].reshape(dx, dx, N).permute(2, 0, 1)
    v, v0 = packed["vvT"].T, packed["v0T"][0]
    inv_bpe = 1.0 / packed["bpe"]
    bad = torch.zeros(N, dtype=torch.bool, device=V.device)
    kw = dict(dtype=V.dtype, device=V.device)
    muopt, sigopt = torch.empty(T, p, N, **kw), torch.empty(T, p * p, N, **kw)
    streams = dict(packed, qmu=qmu, qsig=qsig)
    names = ("cxx", "cx", "cuu", "cu", "cxu", "c0", "cuun", "acpp", "acp", "sigd", "K", "kff",
             "sigc", "qmu", "qsig")
    for t in reversed(range(T)):
        (Cxx, cx, Cuu, cu, Cxu, c0, Cuun, acpp, acp, sigd, K, kff, Sc, mu_x,
         Sx) = _step_blocks(streams, t, dx, du, names)
        mu_opt, Sig, V, v, v0, step_bad = _param_step(
            Cxx, cx, Cuu, cu, Cxu, c0[:, 0], Cuun, acpp, acp, sigd, K, kff, Sc, mu_x, Sx,
            inv_bpe, V, v, v0)
        bad = bad | step_bad
        muopt[t] = mu_opt.T
        sigopt[t] = Sig.reshape(N, -1).T
    return muopt, sigopt, bad


def _kl_interp(mu, S, q_mu, q_sig, a):
    """KL(N(mu, S) ‖ N(q_mu, q_sig)) and interp_KL(q, p; a)
    (pallas_rgps.py:366-393)."""
    dx = mu.shape[-1]
    Lq, inv_dq = _chol_nan(q_sig)
    lam_q = _inv_from_chol(Lq, inv_dq)
    Lp, inv_dp = _chol_nan(S)
    lam_p = _inv_from_chol(Lp, inv_dp)
    diff = q_mu - mu
    kl = 0.5 * (_trace_prod(lam_q, S) + _dot(diff, _mv(lam_q, diff)) + _logdet(_rows(Lq))
                - _logdet(_rows(Lp)) - dx)
    Lm, inv_dm = _chol_nan(a * lam_p + (1.0 - a) * lam_q)
    Sig_n = _inv_from_chol(Lm, inv_dm)
    return kl, _mv(Sig_n, a * _mv(lam_p, mu) + (1.0 - a) * _mv(lam_q, q_mu)), Sig_n


def _rows(L: Tensor):
    """A factor as the nested rows ``cuda_gps._logdet`` reads."""
    n = L.shape[-1]
    return [[L[:, i, j] for j in range(n)] for i in range(n)]


def _cubature_step(mu, S, th_mu, th_sig, sigd, K, kff, Sc):
    """One cubature propagation step with the quadratic forms expanded around
    the central point (pallas_rgps.py:396-531)."""
    dx, du = mu.shape[-1], kff.shape[-1]
    nxu, p1 = dx + du, dx + du + 1
    daug = nxu + 1 + dx
    n_pts = 2 * daug
    s = math.sqrt(float(daug))
    N = mu.shape[0]

    mu_u, Sxu = _joint(mu, S, K, kff, Sc, dx, du, False)
    Lxu, _ = _chol_nan(Sxu)
    mu_z = torch.cat([mu, mu_u, torch.ones_like(mu[:, :1])], dim=1)
    A, B, cvec = matrices_from_vec(th_mu, dx, du)
    S4 = th_sig.reshape(N, p1, dx, p1, dx)

    Zm = mu_z[:, 0, None, None, None] * S4[:, :, :, 0, :]            # (N, p1, dx, dx)
    for b in range(1, p1):
        Zm = Zm + mu_z[:, b, None, None, None] * S4[:, :, :, b, :]
    Qmu = mu_z[:, 0, None, None] * Zm[:, 0]
    for a in range(1, p1):
        Qmu = Qmu + mu_z[:, a, None, None] * Zm[:, a]
    LcC, _ = _chol_nan(symmetrize(sigd + Qmu))
    rowsumC = _ordered_sum(LcC)
    f_c = _mv(A, mu) + _mv(B, mu_u) + cvec

    outs = []
    for k in range(nxu):
        ck = Lxu[:, k:nxu, k]
        Bk = ck[:, 0, None, None] * Zm[:, k]
        Yk = ck[:, 0, None, None, None] * S4[:, k, :, k:nxu, :]      # (N, dx, b, dx)
        for a in range(k + 1, nxu):
            Bk = Bk + ck[:, a - k, None, None] * Zm[:, a]
            Yk = Yk + ck[:, a - k, None, None, None] * S4[:, a, :, k:nxu, :]
        Qk = ck[:, 0, None, None] * Yk[:, :, 0, :]
        for b in range(k + 1, nxu):
            Qk = Qk + ck[:, b - k, None, None] * Yk[:, :, b - k, :]
        dfk = None
        for r in range(k, min(nxu, dx)):
            term = A[:, :, r] * Lxu[:, r, k, None]
            dfk = term if dfk is None else dfk + term
        tail = None
        for r in range(max(k, dx), nxu):
            term = B[:, :, r - dx] * Lxu[:, r, k, None]
            tail = term if tail is None else tail + term
        dfk = tail if dfk is None else dfk + tail
        for sign in (1.0, -1.0):
            cov = symmetrize(sigd + Qmu + (s * s) * Qk + (sign * s) * (Bk + Bk.mT))
            Lk, _ = _chol_nan(cov)
            outs.append(f_c + (sign * s) * dfk + 0.0 * _ordered_sum(Lk))
    for _ in range(2):
        outs.append(f_c + 0.0 * rowsumC)
    for j in range(dx):
        for sign in (1.0, -1.0):
            outs.append(f_c + (sign * s) * LcC[:, :, j])

    mu_n = outs[0]
    for o in outs[1:]:
        mu_n = mu_n + o
    mu_n = mu_n * (1.0 / n_pts)
    S_n = None
    for o in outs:
        c = o - mu_n
        term = c[:, :, None] * c[:, None, :]
        S_n = term if S_n is None else S_n + term
    return mu_n, S_n * (1.0 / n_pts)


def cubature_kl_plain(packed: dict, muopt: Tensor, sigopt: Tensor, qmu: Tensor, qsig: Tensor,
                      a_interp: float = A_INTERP):
    """K16's plain version, with the outputs of :func:`cuda_rgps_cubature_kl`."""
    T, dx, N = packed["cx"].shape
    du = packed["cu"].shape[1]
    mu = packed["mu0"].T
    S = packed["sig0"].reshape(dx, dx, N).permute(2, 0, 1)
    kl = torch.empty(T + 1, N, dtype=mu.dtype, device=mu.device)
    qnmu, qnsig = torch.empty_like(qmu), torch.empty_like(qsig)
    streams = dict(packed, qmu=qmu, qsig=qsig, muopt=muopt, sigopt=sigopt)
    for t in range(T + 1):
        q_mu, q_sig = _step_blocks(streams, t, dx, du, ("qmu", "qsig"))
        kl_t, qn_mu, qn_sig = _kl_interp(mu, S, q_mu, q_sig, a_interp)
        kl[t], qnmu[t], qnsig[t] = kl_t, qn_mu.T, qn_sig.reshape(N, -1).T
        if t < T:
            th_mu, th_sig, sigd, K, kff, Sc = _step_blocks(
                streams, t, dx, du, ("muopt", "sigopt", "sigd", "K", "kff", "sigc"))
            mu, S = _cubature_step(mu, S, th_mu, th_sig, sigd, K, kff, Sc)
    return kl, qnmu, qnsig


# --------------------------------------------------------------------------------------
# Kernel wrappers
# --------------------------------------------------------------------------------------

_P, _I = ctypes.c_void_p, ctypes.c_int
_BACKWARD_KEYS = ("cxx", "cx", "cuu", "cu", "cxu", "c0", "cuun", "acpp", "acp", "sigd", "K",
                  "kff", "sigc")


def cuda_rgps_param_backward(packed: dict, qmu: Tensor, qsig: Tensor):
    """K15 on the streams of :func:`pack_rgps_problem` and the carried
    marginal.  Returns ``(μθ* (T, p, N), Σθ* (T, p², N), bad (N,) bool)``;
    feed the first two straight into :func:`cuda_rgps_cubature_kl`.  CUDA
    tensors launch the kernel; CPU tensors run :func:`param_backward_plain`."""
    if qmu.device.type == "cpu":
        return param_backward_plain(packed, qmu, qsig)
    T, dx, N = packed["cx"].shape
    du = packed["cu"].shape[1]
    p = dx * (dx + du + 1)
    ins = [packed[k] for k in _BACKWARD_KEYS] + [qmu, qsig, packed["bpe"], packed["vT"],
                                                 packed["vvT"], packed["v0T"]]
    code = _build.cuda_operands("K15 rgps_param_backward", *ins)
    kw = dict(dtype=qmu.dtype, device=qmu.device)
    outs = [torch.empty(T, p, N, **kw), torch.empty(T, p * p, N, **kw),
            torch.empty(N, dtype=torch.bool, device=qmu.device)]
    fn = _build.function("rgps.cu", "trajopt_rgps_param_backward",
                         [_I] * 3 + [_P] * 22 + [_I, _I, _P])
    with torch.cuda.device(qmu.device):
        rc = fn(code, dx, du, *(t.data_ptr() for t in ins + outs), T, N,
                torch.cuda.current_stream(qmu.device).cuda_stream)
    _build.check(rc, "K15 rgps_param_backward")
    cuda_rgps_param_backward.launches += 1
    return tuple(outs)


def cuda_rgps_cubature_kl(packed: dict, muopt: Tensor, sigopt: Tensor, qmu: Tensor,
                          qsig: Tensor, a_interp: float = A_INTERP):
    """K16 on the streams of :func:`pack_rgps_problem` (its policy, noise and
    initial state), K15's θ* streams and the carried marginal.  Returns
    ``(kl (T+1, N), q_new μ (T+1, dx, N), q_new Σ (T+1, dx², N))``.  CUDA
    tensors launch the kernel; CPU tensors run :func:`cubature_kl_plain`."""
    if qmu.device.type == "cpu":
        return cubature_kl_plain(packed, muopt, sigopt, qmu, qsig, a_interp)
    T, dx, N = packed["cx"].shape
    du = packed["cu"].shape[1]
    ins = [muopt, sigopt] + [packed[k] for k in ("sigd", "K", "kff", "sigc")] + [
        qmu, qsig, packed["mu0"], packed["sig0"]]
    code = _build.cuda_operands("K16 rgps_cubature_kl", *ins)
    kw = dict(dtype=qmu.dtype, device=qmu.device)
    outs = [torch.empty(T + 1, N, **kw), torch.empty_like(qmu), torch.empty_like(qsig)]
    fn = _build.function("rgps.cu", "trajopt_rgps_cubature_kl",
                         [_I] * 3 + [_P] * 13 + [ctypes.c_double, _I, _I, _P])
    with torch.cuda.device(qmu.device):
        rc = fn(code, dx, du, *(t.data_ptr() for t in ins + outs), float(a_interp), T, N,
                torch.cuda.current_stream(qmu.device).cuda_stream)
    _build.check(rc, "K16 rgps_cubature_kl")
    cuda_rgps_cubature_kl.launches += 1
    return tuple(outs)


cuda_rgps_param_backward.launches = 0
cuda_rgps_cubature_kl.launches = 0


# --------------------------------------------------------------------------------------
# The damped fixed point (rgps/mbrgps.py:386-408), batched over rows
# --------------------------------------------------------------------------------------


def fixed_point_loop(trip, q, param, n_rows: int, group: int, fp_iters: int, where,
                     device) -> tuple[object, object, Tensor, int]:
    """Run ``trip(q) -> (param, bad, kl_any, q_new)`` until no row is active.

    A row is active while its last KL exceeded the tolerance (initially it
    did), it has not diverged and it has made fewer than ``fp_iters`` trips.
    Rows come in groups of ``group`` consecutive rows: a group runs while any
    of its rows is active.  Within a running group only an active row's q
    and trip counter move, while its param, KL and flag take the trip's
    values (``pallas_rgps_fixed_point``'s per-lane masking, pallas_rgps.py:921-940); a
    group that stopped keeps everything (``jax.vmap``'s batched while).  With
    ``group=1`` every row is a ``vmap``ped while loop of its own.  ``where(mask,
    new, old)`` selects per row.  Returns (q, param, diverged, host syncs):
    one sync per trip to test ``any(active)``, and one that ends the loop."""
    kl_any = torch.ones(n_rows, dtype=torch.bool, device=device)
    div = torch.zeros(n_rows, dtype=torch.bool, device=device)
    it = torch.zeros(n_rows, dtype=torch.int64, device=device)
    syncs = 0
    while True:
        active = kl_any & ~div & (it < fp_iters)
        running = active.reshape(-1, group).any(dim=1).repeat_interleave(group)
        syncs += 1
        if not bool(running.any()):
            return q, param, div, syncs
        param_n, bad, kl_any_n, q_n = trip(q)
        q = where(active, q_n, q)
        param = where(running, param_n, param)
        kl_any = torch.where(running, kl_any_n, kl_any)
        div = torch.where(running, bad, div)
        it = it + active.to(it.dtype)


def _where_lanes(mask: Tensor, new, old):
    """Per-row select on streams whose row axis is last."""
    return tuple(torch.where(mask, a, b) for a, b in zip(new, old))


def rgps_fixed_point_packed(packed: dict, qmu: Tensor, qsig: Tensor, *, tol: float = 1e-3,
                            fp_iters: int = 100, a_interp: float = A_INTERP,
                            group: int | None = None, backward=None, cubature=None):
    """The damped fixed point on packed streams: each trip is ``backward``
    (default K15) then ``cubature`` (default K16).  Returns ``(qmu, qsig,
    μθ* (T, p, N), Σθ* (T, p², N), diverged (N,), trips, syncs)``."""
    backward = backward or cuda_rgps_param_backward
    cubature = cubature or cuda_rgps_cubature_kl
    T, dx, N = packed["cx"].shape
    p = packed["acp"].shape[1]
    kw = dict(dtype=qmu.dtype, device=qmu.device)
    mu_dummy = torch.zeros(T, p, N, **kw)
    sig_dummy = torch.eye(p, **kw).reshape(1, p * p, 1).expand(T, p * p, N).contiguous()
    trips = 0

    def trip(q):
        nonlocal trips
        trips += 1
        muopt, sigopt, bad = backward(packed, *q)
        kl, qnmu, qnsig = cubature(packed, muopt, sigopt, *q, a_interp=a_interp)
        return (muopt, sigopt), bad, (kl > tol).any(dim=0), (qnmu, qnsig)

    q, param, div, syncs = fixed_point_loop(
        trip, (qmu, qsig), (mu_dummy, sig_dummy), N, group or N, fp_iters, _where_lanes,
        qmu.device)
    return q[0], q[1], param[0], param[1], div, trips, syncs


def cuda_rgps_fixed_point(agCpp: Tensor, agcp: Tensor, ctl: LinearGaussianPolicy,
                          cost: QuadraticCost, xdist0: GaussianSequence, beta_plus_eta: Tensor,
                          mu0: Tensor, sigma0: Tensor, noise: Tensor, *, tol: float = 1e-3,
                          fp_iters: int = 100, a_interp: float = A_INTERP,
                          group: int | None = None):
    """Damped adversary fixed point for N rows through K15 and K16
    (``pallas_rgps_fixed_point``'s contract).  Batch-leading operands
    (``agCpp (N, T, p, p)``, ``cost (N, T+1, …)``, ``xdist0 (N, T+1, …)``,
    ``beta_plus_eta (N,)``, …).  With ``group=None`` all rows form one group:
    the loop runs while any row is active and a frozen row's q and trip
    counter are masked, as in ``pallas_rgps_fixed_point``; the backward pass is a function
    of q, so a frozen row recomputes its parameters from its frozen q.  A
    smaller ``group`` freezes each group of rows as a whole once none of its
    rows is active (the solver's instances, each with its β-candidates).
    Returns ``(q (N, T+1, …), param (N, T, …), diverged (N,))``; the trips
    and host syncs of all calls add up in ``cuda_rgps_fixed_point.trips`` and
    ``.syncs``."""
    packed = pack_rgps_problem(cost, ctl, noise, agCpp, agcp, beta_plus_eta, mu0, sigma0)
    qmu, qsig = pack_rgps_xdist(xdist0)
    qmu, qsig, muopt, sigopt, div, trips, syncs = rgps_fixed_point_packed(
        packed, qmu, qsig, tol=tol, fp_iters=fp_iters, a_interp=a_interp, group=group)
    cuda_rgps_fixed_point.trips += trips
    cuda_rgps_fixed_point.syncs += syncs
    return unpack_rgps_xdist(qmu, qsig), unpack_rgps_param(muopt, sigopt), div


cuda_rgps_fixed_point.trips = 0
cuda_rgps_fixed_point.syncs = 0
