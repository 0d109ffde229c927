"""Single-problem parallel-in-time iLQR backward pass as one CUDA kernel (K5).

Counterpart of ``trajopt_tpu/core/pallas_pscan.py`` (``_pscan_kernel``):
:func:`cuda_pilqr_backward` and :func:`cuda_pilqr_backward_reg` keep the
contracts of ``pallas_pilqr_backward`` and ``pallas_pilqr_backward_reg``.  CUDA
tensors launch ``csrc/pscan_backward.cu`` on the route :func:`k5_route`
picks from the shape; CPU tensors run :func:`pilqr_backward_plain`, the
lane-major pass of ``core.pscan_lqr`` with the kernel's Cholesky guard.

The kernel keeps the TPU kernel's own Cholesky guard: a pivot that is not
positive or not finite becomes 1.  So a non-PD R or Quu gives finite gains and
no divergence flag here, where the ``pscan`` engine (``core.pscan_lqr``, on
``jnp.linalg.cholesky``'s NaN contract) flags it: each engine keeps its JAX
counterpart's semantics.
"""

from __future__ import annotations

import ctypes

import torch
from torch import Tensor

from ..kernels import _build
from .cuda_lqr import _chol
from .pscan_lqr import delta_backward, suffix_scan_lanes
from .types import LinearPolicy, QuadraticCost, QuadraticValue

# --------------------------------------------------------------------------------------
# Plain PyTorch version
# --------------------------------------------------------------------------------------


def _guarded_cholesky(S: Tensor) -> Tensor:
    """Lower Cholesky factor of each matrix of ``S (..., n, n)`` with the
    kernel's guard (``cuda_lqr._chol``): a pivot that is not positive or not
    finite becomes 1, so the factor stays finite."""
    n = S.shape[-1]
    L, _, _ = _chol(S.reshape(-1, n, n))
    zero = torch.zeros_like(L[0][0])
    rows = [torch.stack([L[i][j] if j <= i else zero for j in range(n)], dim=-1)
            for i in range(n)]
    return torch.stack(rows, dim=-2).reshape(S.shape)


def pilqr_backward_plain(
    cost: QuadraticCost, A: Tensor, B: Tensor
) -> tuple[LinearPolicy, QuadraticValue, Tensor]:
    """K5's plain version: the lane-major pass of ``core.pscan_lqr`` (partial
    pivoting Gauss–Jordan combine, K5's doubling schedule) with the kernel's
    Cholesky guard in place of the NaN contract."""
    return delta_backward(cost, A, B, suffix_scan_lanes, factor=_guarded_cholesky)


# --------------------------------------------------------------------------------------
# Kernel wrappers
# --------------------------------------------------------------------------------------

# The cluster route (csrc/pscan_backward.cu): one thread a position, at most
# K5_MAX_THREADS positions a block.  A cluster of one block (its barrier a
# block barrier) up to K5_ONE_BLOCK_POSITIONS positions; beyond, a cluster of
# K5_MAX_CLUSTER blocks, the largest (the non-portable size): a cluster
# barrier costs about 850 cycles against 128 for a block's, but each larger
# cluster ran faster at T=200, 333 and 1000, dims 4/2 (PERF.md).  A
# block's shared memory is the H100's.
K5_MAX_THREADS = 256
K5_ONE_BLOCK_POSITIONS = 128
K5_MAX_CLUSTER = 16
K5_SMEM_BYTES = 232448


def k5_cluster_bytes(P: int, dx: int, itemsize: int) -> int:
    """Shared memory of a cluster-route block of ``P`` positions: two copies
    of their elements (3dx² + 2dx entries each), their dV terms and the
    reduction's eight pairs (csrc/pscan_backward.cu ``cluster_bytes``)."""
    return itemsize * (2 * (3 * dx * dx + 2 * dx) * P + 2 * P + 2 * (K5_MAX_THREADS // 32))


def k5_route(T: int, dx: int, dtype: torch.dtype) -> tuple[str, int]:
    """K5's route for a horizon ``T``, state size ``dx`` and ``dtype``, from the
    shape alone: ``("cluster", C)`` when a cluster of C blocks holds the T+1
    elements in shared memory, one thread a position (C = 1 up to
    ``K5_ONE_BLOCK_POSITIONS`` positions, else ``K5_MAX_CLUSTER``);
    ``("global", 0)`` beyond that (the one-block kernel with a global
    scratch)."""
    n = T + 1
    itemsize = torch.empty((), dtype=dtype).element_size()
    C = 1 if n <= K5_ONE_BLOCK_POSITIONS else K5_MAX_CLUSTER
    P = -(-n // C)
    if P <= K5_MAX_THREADS and k5_cluster_bytes(P, dx, itemsize) <= K5_SMEM_BYTES:
        return "cluster", C
    return "global", 0


_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_I, _I, _I] + [_P] * 13 + [_I, _I, _P]
_MAX_CLUSTERS_ARGTYPES = [_I] * 5 + [_P]


def k5_max_clusters(T: int, dx: int, du: int, dtype: torch.dtype, cluster: int) -> int:
    """How many clusters of the cluster route's launch at this shape the card
    holds at once (``cudaOccupancyMaxActiveClusters``; 0: it would be refused)."""
    code = _build.DTYPE_CODES[str(dtype)]
    fn = _build.function("pscan_backward.cu", "trajopt_pscan_max_clusters", _MAX_CLUSTERS_ARGTYPES)
    out = ctypes.c_int(-1)
    _build.check(fn(code, dx, du, T, cluster, ctypes.addressof(out)), "K5 max_clusters")
    return out.value


def cuda_pilqr_backward(
    cost: QuadraticCost, A: Tensor, B: Tensor
) -> tuple[LinearPolicy, QuadraticValue, Tensor]:
    """Single-problem parallel-in-time iLQR backward pass (λ = 0) as one
    launch of K5: the contract of ``core.pscan_lqr.pilqr_backward``.

    ``cost`` stacks have T+1 steps (slice T is the terminal cost; the kernel
    reads steps t < T of Cuu, cu and Cxu), ``A (T, dx, dx)``, ``B (T, dx, du)``.
    CUDA tensors launch the kernel on :func:`k5_route`'s route; CPU tensors
    run the plain version."""
    if A.device.type == "cpu":
        return pilqr_backward_plain(cost, A, B)
    out = launch_route(cost, A, B, k5_route(A.shape[0], A.shape[-1], A.dtype))
    cuda_pilqr_backward.launches += 1
    return out


def launch_route(
    cost: QuadraticCost, A: Tensor, B: Tensor, route: tuple[str, int]
) -> tuple[LinearPolicy, QuadraticValue, Tensor]:
    """One launch of K5 on CUDA tensors along ``route`` (``("global", 0)`` or
    ``("cluster", C)``), counted nowhere: :func:`cuda_pilqr_backward` takes
    :func:`k5_route`'s route, a device check may take the other."""
    T, dx, du = A.shape[0], A.shape[-1], B.shape[-1]
    if T < 1:
        raise ValueError("K5 pscan_backward: the horizon must be at least 1")
    ins = [cost.Cxx, cost.cx, cost.Cuu, cost.cu, cost.Cxu, A, B]
    if cost.Cxx.shape[0] < T + 1 or cost.cx.shape[0] < T + 1 or min(
        x.shape[0] for x in ins[2:5]
    ) < T:
        raise ValueError("K5 pscan_backward: the cost stacks are shorter than the horizon")
    ins = [x.contiguous() for x in ins]
    code = _build.cuda_operands("K5 pscan_backward", *ins)
    kw = dict(dtype=A.dtype, device=A.device)
    K = torch.empty(T, du, dx, **kw)
    kff = torch.empty(T, du, **kw)
    S = torch.empty(T + 1, dx, dx, **kw)
    s = torch.empty(T + 1, dx, **kw)
    dV = torch.empty(2, **kw)
    name, cluster = route
    scratch = torch.empty(2 * (3 * dx * dx + 2 * dx) * (T + 1) if name == "global" else 0,
                          **kw)
    fn = _build.function("pscan_backward.cu", "trajopt_pscan_backward", _ARGTYPES)
    with torch.cuda.device(A.device):
        rc = fn(code, dx, du, *(t.data_ptr() for t in ins + [K, kff, S, s, dV, scratch]),
                T, cluster, torch.cuda.current_stream(A.device).cuda_stream)
    _build.check(rc, f"K5 pscan_backward ({name} route)")
    value = QuadraticValue(V=S, v=s, v0=torch.zeros(T + 1, **kw))
    return LinearPolicy(K=K, kff=kff), value, dV


cuda_pilqr_backward.launches = 0


def cuda_pilqr_backward_reg(
    cost: QuadraticCost, A: Tensor, B: Tensor, lmbda: Tensor | float = 0.0
) -> tuple[LinearPolicy, QuadraticValue, Tensor, Tensor]:
    """λ folded into the action Hessian before the kernel (``Cuu + λI``), plus
    a NaN/Inf divergence flag on K, kff and V: the ``backward="cuda-pscan"``
    engine of ``parallel.mpc.make_ilqr_solver``."""
    du = B.shape[-1]
    lam_eye = lmbda * torch.eye(du, dtype=A.dtype, device=A.device)
    ctl, value, dV = cuda_pilqr_backward(cost._replace(Cuu=cost.Cuu + lam_eye), A, B)
    diverged = ~(
        torch.isfinite(ctl.K).all()
        & torch.isfinite(ctl.kff).all()
        & torch.isfinite(value.V).all()
    )
    return ctl, value, dV, diverged
