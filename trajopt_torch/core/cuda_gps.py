"""The GPS dual chain as two CUDA kernels, K6 and K7 (``csrc/gps.cu``).

Counterpart of ``trajopt_tpu/core/pallas_gps.py``.  One dual evaluation of a
batch of GPS problems is two launches:

* K6, :func:`cuda_gps_backward_packed`: the KL augmentation of the cost fused
  into the −1/α-scaled soft-Riccati backward pass; it gives the controller
  (K, kff, Σ_ctl), the t = 0 value (V₀, v₀, c₀) and a divergence flag;
* K7, :func:`cuda_gps_forward_kl_packed`: the exact Gaussian propagation of
  the state under the new controller fused with Σ_t KL(new‖old).

Operands are structure-of-arrays streams with time leading, ``(T, entries,
N)`` (entry ``i·cols + j`` of each per-step block for all N instances is one
contiguous row; no padding).  :func:`pack_gps` writes them once per dual and
:func:`pack_gps_alpha` only the α plane per evaluation; K6 writes the
controller in the layout K7 reads.  :func:`cuda_gps_backward` and
:func:`cuda_gps_forward_kl` take and return batch-leading containers, with the
contracts of ``pallas_gps_backward`` and ``pallas_gps_forward_kl``.

Both kernels keep the TPU kernels' Cholesky guard (``cuda_lqr._chol``): a
pivot that is not positive or not finite becomes 1, so a non-PD −Quu gives
finite outputs and sets K6's flag, where the ``scan`` chain
(``scan_lqr.gps_backward``) flags it with NaN.  CUDA tensors launch the
kernels; CPU tensors run the plain versions below, which do the kernels'
arithmetic step by step, batched over N, with every sum in the kernels' order.
"""

from __future__ import annotations

import ctypes

import torch
from torch import Tensor

from ..kernels import _build
from .cuda_lqr import _chol, _chol_solve, from_soa, to_soa
from .types import (
    LinearGaussianDynamics,
    LinearGaussianPolicy,
    QuadraticCost,
    symmetrize,
)

_LOG_2PI = 1.8378770664093453
_LOG_2 = 0.6931471805599453

# --------------------------------------------------------------------------------------
# Layout: batch-leading ↔ structure of arrays (T, entries, N)
# --------------------------------------------------------------------------------------

def _pack_dyn_old(dyn: LinearGaussianDynamics, old: LinearGaussianPolicy, mu0: Tensor,
                  sigma0: Tensor) -> dict:
    N = dyn.A.shape[0]
    return dict(
        A=to_soa(dyn.A, N), B=to_soa(dyn.B, N), c=to_soa(dyn.c, N), sigd=to_soa(dyn.sigma, N),
        Ko=to_soa(old.K, N), ko=to_soa(old.kff, N), sigo=to_soa(old.sigma, N),
        mu0=to_soa(mu0[:, None], N)[0], sig0=to_soa(sigma0[:, None], N)[0],
    )


def pack_gps(cost: QuadraticCost, dyn: LinearGaussianDynamics, old: LinearGaussianPolicy,
             mu0: Tensor, sigma0: Tensor) -> dict:
    """The operands of a dual evaluation but α, in the kernels' layout, once
    per linearization.  Batch-leading inputs: ``cost`` stacks ``(N, T+1, …)``
    (slice T the terminal cost), ``dyn``/``old`` ``(N, T, …)``, ``mu0 (N, dx)``,
    ``sigma0 (N, dx, dx)``."""
    N, T = dyn.A.shape[:2]
    return dict(
        cxx=to_soa(cost.Cxx[:, :T], N), cx=to_soa(cost.cx[:, :T], N),
        cuu=to_soa(cost.Cuu[:, :T], N), cu=to_soa(cost.cu[:, :T], N),
        cxu=to_soa(cost.Cxu[:, :T], N), c0=to_soa(cost.c0[:, :T, None], N),
        vT=to_soa(cost.Cxx[:, T:], N)[0], vvT=to_soa(cost.cx[:, T:], N)[0],
        v0T=to_soa(cost.c0[:, T:, None], N)[0],
        **_pack_dyn_old(dyn, old, mu0, sigma0),
    )


def pack_gps_alpha(alpha: Tensor) -> Tensor:
    """Per-instance per-step dual ``(N, T)`` → ``(T, 1, N)``, the only operand
    that changes between the evaluations of one dual."""
    return to_soa(alpha[..., None], alpha.shape[0])


def unpack_gps_policy(K_l: Tensor, kff_l: Tensor, sigc_l: Tensor, dx: int,
                      du: int) -> LinearGaussianPolicy:
    """K6's controller streams → a batch-leading ``LinearGaussianPolicy``."""
    N = K_l.shape[-1]
    return LinearGaussianPolicy(K=from_soa(K_l, N, (du, dx)), kff=from_soa(kff_l, N, (du,)),
                                sigma=from_soa(sigc_l, N, (du, du)))


def quad_expectation_lanes(V0_l: Tensor, vv0_l: Tensor, c0_l: Tensor, mu0_l: Tensor,
                           sig0_l: Tensor) -> Tensor:
    """E[xᵀV₀x + v₀ᵀx + c₀] under N(μ₀, Σ₀) on K6's value outputs and the
    packed initial state (gps/src/util.cpp:123-134) → ``(N,)``."""
    dx = vv0_l.shape[0]
    quad = sum(V0_l[i * dx + j] * (mu0_l[i] * mu0_l[j] + sig0_l[i * dx + j])
               for i in range(dx) for j in range(dx))
    return quad + sum(vv0_l[i] * mu0_l[i] for i in range(dx)) + c0_l[0]


# --------------------------------------------------------------------------------------
# Plain PyTorch versions: matrices (N, rows, cols), every sum in index order
# --------------------------------------------------------------------------------------


def _mm(A: Tensor, B: Tensor) -> Tensor:
    acc = A[..., :, :1] * B[..., :1, :]
    for k in range(1, A.shape[-1]):
        acc = acc + A[..., :, k:k + 1] * B[..., k:k + 1, :]
    return acc


def _mm_tn(A: Tensor, B: Tensor) -> Tensor:
    return _mm(A.mT, B)


def _mm_nt(A: Tensor, B: Tensor) -> Tensor:
    return _mm(A, B.mT)


def _mv(A: Tensor, x: Tensor) -> Tensor:
    return _mm(A, x[..., None])[..., 0]


def _mv_tn(A: Tensor, x: Tensor) -> Tensor:
    return _mv(A.mT, x)


def _ordered_sum(terms: Tensor) -> Tensor:
    acc = terms[..., 0]
    for k in range(1, terms.shape[-1]):
        acc = acc + terms[..., k]
    return acc


def _dot(x: Tensor, y: Tensor) -> Tensor:
    return _ordered_sum(x * y)


def _trace_prod(M: Tensor, Nm: Tensor) -> Tensor:
    """tr(M Nm) = Σᵢⱼ Mᵢⱼ Nmⱼᵢ, i outer."""
    return _ordered_sum((M * Nm.mT).flatten(-2))


def _chol_inv(L, inv_d) -> Tensor:
    n = len(inv_d)
    eye = torch.eye(n, dtype=inv_d[0].dtype, device=inv_d[0].device)
    return _chol_solve(L, inv_d, eye.expand(inv_d[0].shape[0], n, n))


def _logdet(L) -> Tensor:
    acc = torch.log(L[0][0])
    for j in range(1, len(L)):
        acc = acc + torch.log(L[j][j])
    return 2.0 * acc


def _backward_step(Cxx, cx, Cuu, cu, Cxu, c0, A, B, c, sigd, Ko, ko, sigo, a, V, v, v0, bad):
    """One step of K6 for every instance (pallas_gps.py:115-180)."""
    du = Cuu.shape[-1]
    Lo, inv_do, bad_o = _chol(symmetrize(sigo))
    lam = _chol_inv(Lo, inv_do)
    lamKo, lamko = _mm(lam, Ko), _mv(lam, ko)
    ha = 0.5 * a
    ha3 = ha[:, None, None]
    agCxx = Cxx + ha3 * _mm_tn(Ko, lamKo)
    agCuu = Cuu + ha3 * lam
    agCxu = Cxu - ha3 * lamKo.mT
    agcx = cx + a[:, None] * _mv_tn(Ko, lamko)
    agcu = cu - a[:, None] * lamko
    agc0 = c0 + ha * (du * _LOG_2PI + _logdet(Lo)) + ha * _dot(ko, lamko)

    nia = -torch.reciprocal(a)
    VA, VB, Vc = _mm(V, A), _mm(V, B), _mv(V, c)
    Qxx = nia[:, None, None] * (agCxx + _mm_tn(A, VA))
    Quu = nia[:, None, None] * (agCuu + _mm_tn(B, VB))
    QuxT = nia[:, None, None] * (agCxu + _mm_tn(A, VB))          # Quxᵀ, (dx, du)
    qu = nia[:, None] * (agcu + 2.0 * _mv_tn(B, Vc) + _mv_tn(B, v))
    qx = nia[:, None] * (agcx + 2.0 * _mv_tn(A, Vc) + _mv_tn(A, v))
    q0 = nia * (agc0 + v0 + _dot(c, Vc) + _trace_prod(V, sigd) + _dot(v, c))

    Ln, inv_dn, bad_n = _chol(symmetrize(-Quu))
    K = _chol_solve(Ln, inv_dn, QuxT.mT)
    kff = 0.5 * _chol_solve(Ln, inv_dn, qu[..., None])[..., 0]
    sigc = 0.5 * _chol_inv(Ln, inv_dn)

    na = -a
    V = symmetrize(na[:, None, None] * (Qxx + _mm(QuxT, K)))
    v = na[:, None] * (qx + 2.0 * _mv(QuxT, kff))
    logdet_m2Quu = du * _LOG_2 + _logdet(Ln)
    v0 = na * (0.5 * _dot(qu, kff) + q0 + 0.5 * (du * _LOG_2PI - logdet_m2Quu))
    return K, kff, sigc, V, v, v0, bad | bad_o | bad_n


def _blocks(streams: dict, names, t: int, dx: int, du: int):
    """Step t of each named stream as ``(N, rows, cols)`` blocks, or ``(N,
    rows)`` for vectors."""
    N = streams["A"].shape[-1]
    shapes = dict(cxx=(dx, dx), cuu=(du, du), cxu=(dx, du), A=(dx, dx), B=(dx, du),
                  sigd=(dx, dx), Ko=(du, dx), sigo=(du, du), K=(du, dx), sigc=(du, du))
    return [streams[k][t].reshape(*shapes[k], N).permute(2, 0, 1) if k in shapes
            else streams[k][t].T for k in names]


def gps_backward_plain(packed: dict, alpha_l: Tensor):
    """K6's plain version, with the outputs of :func:`cuda_gps_backward_packed`."""
    T, dx, N = packed["cx"].shape
    du = packed["cu"].shape[1]
    V = packed["vT"].reshape(dx, dx, N).permute(2, 0, 1)
    v, v0 = packed["vvT"].T, packed["v0T"][0]
    bad = torch.zeros(N, dtype=torch.bool, device=V.device)
    kw = dict(dtype=V.dtype, device=V.device)
    K_out = torch.empty(T, du * dx, N, **kw)
    kff_out = torch.empty(T, du, N, **kw)
    sigc_out = torch.empty(T, du * du, N, **kw)
    names = ("cxx", "cx", "cuu", "cu", "cxu", "c0", "A", "B", "c", "sigd", "Ko", "ko", "sigo")
    for t in reversed(range(T)):
        Cxx, cx, Cuu, cu, Cxu, c0, A, B, c, sigd, Ko, ko, sigo = _blocks(packed, names, t, dx, du)
        K, kff, sigc, V, v, v0, bad = _backward_step(
            Cxx, cx, Cuu, cu, Cxu, c0[:, 0], A, B, c, sigd, Ko, ko, sigo, alpha_l[t, 0],
            V, v, v0, bad)
        K_out[t] = K.reshape(N, -1).T
        kff_out[t] = kff.T
        sigc_out[t] = sigc.reshape(N, -1).T
    return (K_out, kff_out, sigc_out, V.reshape(N, -1).T.contiguous(), v.T.contiguous(),
            v0[None].contiguous(), bad)


def gps_forward_kl_plain(packed: dict, K_l: Tensor, kff_l: Tensor, sigc_l: Tensor):
    """K7's plain version, with the outputs of :func:`cuda_gps_forward_kl_packed`."""
    T, _, N = packed["A"].shape
    dx, du = packed["mu0"].shape[0], packed["ko"].shape[1]
    mu = packed["mu0"].T
    Sx = packed["sig0"].reshape(dx, dx, N).permute(2, 0, 1)
    kl = torch.zeros(N, dtype=mu.dtype, device=mu.device)
    streams = dict(packed, K=K_l, kff=kff_l, sigc=sigc_l)
    names = ("A", "B", "c", "sigd", "K", "kff", "sigc", "Ko", "ko", "sigo")
    for t in range(T):
        A, B, c, sigd, K, kff, sigc, Ko, ko, sigo = _blocks(streams, names, t, dx, du)
        Lo, inv_do, _ = _chol(symmetrize(sigo))
        lam = _chol_inv(Lo, inv_do)
        Lc, _, _ = _chol(symmetrize(sigc))
        dK, dk = Ko - K, kff - ko
        lam_dK, lam_dk = _mm(lam, dK), _mv(lam, dk)
        diff_K, diff_crs = _mm_tn(dK, lam_dK), _mv_tn(dK, lam_dk)
        kl = kl + (
            0.5 * (_logdet(Lo) - _logdet(Lc))
            + 0.5 * _trace_prod(lam, sigc)
            - 0.5 * du
            + 0.5 * _trace_prod(diff_K, Sx)
            + 0.5 * _dot(mu, _mv(diff_K, mu))
            - _dot(mu, diff_crs)
            + 0.5 * _dot(dk, lam_dk)
        )
        mu_u = _mv(K, mu) + kff
        KS = _mm(K, Sx)
        sigma_u = sigc + _mm_nt(KS, K)
        Acr = _mm_nt(A, KS)                                  # A Σ Kᵀ
        AcrBt = _mm_nt(Acr, B)
        mu = _mv(A, mu) + _mv(B, mu_u) + c
        Sx = symmetrize(sigd + _mm_nt(_mm(A, Sx), A) + AcrBt + AcrBt.mT
                        + _mm_nt(_mm(B, sigma_u), B))
    return kl[None], mu.T.contiguous(), Sx.reshape(N, -1).T.contiguous()


# --------------------------------------------------------------------------------------
# Kernel wrappers
# --------------------------------------------------------------------------------------

_P, _I = ctypes.c_void_p, ctypes.c_int
_BACKWARD_KEYS = ("cxx", "cx", "cuu", "cu", "cxu", "c0", "A", "B", "c", "sigd", "Ko", "ko",
                  "sigo")


def cuda_gps_backward_packed(packed: dict, alpha_l: Tensor):
    """K6 on the streams of :func:`pack_gps` and the α plane ``(T, 1, N)``.

    Returns ``(K (T, du·dx, N), kff (T, du, N), Σ_ctl (T, du·du, N), V₀
    (dx·dx, N), v₀ (dx, N), c₀ (1, N), diverged (N,) bool)``; feed the first
    three straight into :func:`cuda_gps_forward_kl_packed`.  CUDA tensors
    launch the kernel; CPU tensors run :func:`gps_backward_plain`."""
    if packed["A"].device.type == "cpu":
        return gps_backward_plain(packed, alpha_l)
    T, dx, N = packed["cx"].shape
    du = packed["cu"].shape[1]
    ins = [packed[k] for k in _BACKWARD_KEYS] + [alpha_l, packed["vT"], packed["vvT"],
                                                 packed["v0T"]]
    code = _build.cuda_operands("K6 gps_backward", *ins)
    kw = dict(dtype=alpha_l.dtype, device=alpha_l.device)
    outs = [torch.empty(T, du * dx, N, **kw), torch.empty(T, du, N, **kw),
            torch.empty(T, du * du, N, **kw), torch.empty(dx * dx, N, **kw),
            torch.empty(dx, N, **kw), torch.empty(1, N, **kw),
            torch.empty(N, dtype=torch.bool, device=alpha_l.device)]
    fn = _build.function("gps.cu", "trajopt_gps_backward", [_I] * 3 + [_P] * 24 + [_I, _I, _P])
    with torch.cuda.device(alpha_l.device):
        rc = fn(code, dx, du, *(t.data_ptr() for t in ins + outs), T, N,
                torch.cuda.current_stream(alpha_l.device).cuda_stream)
    _build.check(rc, "K6 gps_backward")
    cuda_gps_backward_packed.launches += 1
    return tuple(outs)


def cuda_gps_forward_kl_packed(packed: dict, K_l: Tensor, kff_l: Tensor, sigc_l: Tensor):
    """K7 on the streams of :func:`pack_gps` (only its dynamics, old policy and
    initial state) and K6's controller streams.

    Returns ``(Σ_t KL (1, N), μ_T (dx, N), Σ_T (dx·dx, N))``.  CUDA tensors
    launch the kernel; CPU tensors run :func:`gps_forward_kl_plain`."""
    if packed["A"].device.type == "cpu":
        return gps_forward_kl_plain(packed, K_l, kff_l, sigc_l)
    T, dx, N = packed["c"].shape
    du = packed["ko"].shape[1]
    ins = [packed[k] for k in ("A", "B", "c", "sigd")] + [K_l, kff_l, sigc_l] + [
        packed[k] for k in ("Ko", "ko", "sigo", "mu0", "sig0")]
    code = _build.cuda_operands("K7 gps_forward_kl", *ins)
    kw = dict(dtype=K_l.dtype, device=K_l.device)
    outs = [torch.empty(1, N, **kw), torch.empty(dx, N, **kw), torch.empty(dx * dx, N, **kw)]
    fn = _build.function("gps.cu", "trajopt_gps_forward_kl", [_I] * 3 + [_P] * 15 + [_I, _I, _P])
    with torch.cuda.device(K_l.device):
        rc = fn(code, dx, du, *(t.data_ptr() for t in ins + outs), T, N,
                torch.cuda.current_stream(K_l.device).cuda_stream)
    _build.check(rc, "K7 gps_forward_kl")
    cuda_gps_forward_kl_packed.launches += 1
    return tuple(outs)


cuda_gps_backward_packed.launches = 0
cuda_gps_forward_kl_packed.launches = 0


def cuda_gps_backward(cost: QuadraticCost, dyn: LinearGaussianDynamics,
                      old: LinearGaussianPolicy, alpha: Tensor):
    """K6 on batch-leading operands (``pallas_gps_backward``'s contract):
    ``cost`` ``(N, T+1, …)``, ``dyn``/``old`` ``(N, T, …)``, ``alpha (N, T)``.
    Returns (policy (N, T, …), V₀ (N, dx, dx), v₀ (N, dx), c₀ (N,),
    diverged (N,))."""
    N, dx = dyn.A.shape[0], dyn.A.shape[-1]
    du = dyn.B.shape[-1]
    zero = dyn.A.new_zeros(N, dx)
    packed = pack_gps(cost, dyn, old, zero, zero[..., None].expand(N, dx, dx))
    K_l, kff_l, sigc_l, V0, vv0, c0, bad = cuda_gps_backward_packed(packed, pack_gps_alpha(alpha))
    return (unpack_gps_policy(K_l, kff_l, sigc_l, dx, du), V0.T.reshape(N, dx, dx), vv0.T,
            c0[0], bad)


def cuda_gps_forward_kl(dyn: LinearGaussianDynamics, new: LinearGaussianPolicy,
                        old: LinearGaussianPolicy, mu0: Tensor, sigma0: Tensor):
    """K7 on batch-leading operands (``pallas_gps_forward_kl``'s contract).
    Returns (Σ_t KL (N,), μ_T (N, dx), Σ_T (N, dx, dx))."""
    N, dx = dyn.A.shape[0], dyn.A.shape[-1]
    packed = _pack_dyn_old(dyn, old, mu0, sigma0)
    kl, muT, sigT = cuda_gps_forward_kl_packed(
        packed, to_soa(new.K, N), to_soa(new.kff, N), to_soa(new.sigma, N))
    return kl[0], muT.T, sigT.T.reshape(N, dx, dx)
