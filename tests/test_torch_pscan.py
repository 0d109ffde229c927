"""Parity of the port's parallel-in-time backward passes with trajopt_tpu's,
float64 on the CPU: ``core/pscan_lqr`` (the doubling-schedule suffix scan)
against JAX's ``lax.associative_scan`` passes, and K5's plain version
(``core/cuda_pscan``) against ``pallas_pilqr_backward(_reg)(…, interpret=True)``.

Tolerances are those of tests/test_pallas_pscan.py: rtol 1e-8 on K and kff,
1e-7 on V, v and dV.  The interpret-mode Pallas references run under
``jax.disable_jit()``: compiled whole, their unrolled tile body costs tens of
seconds of XLA compile per shape, op by op a few seconds.  Every JAX
reference is frozen (``tests/make_torch_refs.py``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ref_impl import random_quadratic_problem
from trajopt_torch.core import cuda_pscan
from trajopt_torch.core import pscan_lqr as port
from trajopt_torch.core.types import LinearDynamics, QuadraticCost
from trajopt_tpu.core import pallas_pscan as jax_pallas
from trajopt_tpu.core import pscan_lqr as jax_pscan
from trajopt_tpu.core import types as jax_types

from make_torch_refs import reference

torch.set_num_threads(1)

TOL_GAINS = dict(rtol=1e-8, atol=1e-9)
TOL_VALUE = dict(rtol=1e-7, atol=1e-8)
KEYS = ("Cxx", "cx", "Cuu", "cu", "Cxu", "c0")

# jitted once per module; each call with a new shape compiles once more
_jax_pilqr = jax.jit(jax_pscan.pilqr_backward)
_jax_priccati = jax.jit(jax_pscan.priccati_backward)
_jax_reg = jax.jit(jax_pscan.pilqr_backward_reg)


def _problem(T, dx, du, non_pd=False):
    p = random_quadratic_problem(np.random.default_rng(600 + T), T, dx=dx, du=du)
    if non_pd:
        p["Cuu"][T // 2] = -4.0 * np.eye(du)
    jc = jax_types.QuadraticCost(*(jnp.asarray(p[k]) for k in KEYS))
    tc = QuadraticCost(*(torch.as_tensor(p[k]) for k in KEYS))
    return p, jc, tc


@reference(__file__)
def _ref(kind, T, dx, du, non_pd=False, lmbda=0.0):
    """JAX's pass of ``kind`` on ``_problem(T, dx, du, non_pd)``: the scan
    engines jitted, the Pallas kernels in interpret mode under
    ``jax.disable_jit()``."""
    p, jc, _ = _problem(T, dx, du, non_pd)
    A, B = jnp.asarray(p["A"]), jnp.asarray(p["B"])
    if kind == "pilqr":
        return _jax_pilqr(jc, A, B)
    if kind == "priccati":
        return _jax_priccati(jc, jax_types.LinearDynamics(A, B, jnp.asarray(p["c"])))
    if kind == "reg":
        return _jax_reg(jc, A, B, lmbda)
    with jax.disable_jit():
        if kind == "pallas":
            return jax_pallas.pallas_pilqr_backward(jc, A, B, interpret=True)
        return jax_pallas.pallas_pilqr_backward_reg(jc, A, B, lmbda, interpret=True)


def _assert_backward(pol, value, dV, ref_pol, ref_value, ref_dV):
    np.testing.assert_allclose(pol.K.numpy(), np.asarray(ref_pol.K), **TOL_GAINS)
    np.testing.assert_allclose(pol.kff.numpy(), np.asarray(ref_pol.kff), **TOL_GAINS)
    np.testing.assert_allclose(value.V.numpy(), np.asarray(ref_value.V), **TOL_VALUE)
    np.testing.assert_allclose(value.v.numpy(), np.asarray(ref_value.v), **TOL_VALUE)
    np.testing.assert_allclose(dV.numpy(), np.asarray(ref_dV), rtol=1e-7)


def test_pilqr_backward_matches_jax():
    p, jc, tc = _problem(61, 3, 2)
    ref = _ref("pilqr", 61, 3, 2)
    out = port.pilqr_backward(tc, torch.as_tensor(p["A"]), torch.as_tensor(p["B"]))
    _assert_backward(*out, *ref)


def test_priccati_backward_matches_jax():
    p, jc, tc = _problem(130, 2, 1)
    pol_j, val_j = _ref("priccati", 130, 2, 1)
    pol, val = port.priccati_backward(
        tc, LinearDynamics(*(torch.as_tensor(p[k]) for k in ("A", "B", "c")))
    )
    np.testing.assert_allclose(pol.K.numpy(), np.asarray(pol_j.K), **TOL_GAINS)
    np.testing.assert_allclose(pol.kff.numpy(), np.asarray(pol_j.kff), **TOL_GAINS)
    np.testing.assert_allclose(val.V.numpy(), np.asarray(val_j.V), **TOL_VALUE)
    np.testing.assert_allclose(val.v.numpy(), np.asarray(val_j.v), **TOL_VALUE)


@pytest.mark.parametrize("lmbda", [0.0, 0.6])
def test_lanes_and_reg_match_jax(lmbda):
    """The lane-major pass and its λ-folded engine against JAX's; at λ = 0 the
    engine is the lane-major pass itself."""
    p, jc, tc = _problem(130, 2, 1)
    A, B = torch.as_tensor(p["A"]), torch.as_tensor(p["B"])
    pol_j, val_j, dV_j, div_j = _ref("reg", 130, 2, 1, False, lmbda)
    pol, val, dV, div = port.pilqr_backward_reg(tc, A, B, lmbda)
    assert not bool(div) and not bool(div_j)
    _assert_backward(pol, val, dV, pol_j, val_j, dV_j)
    if lmbda == 0.0:
        _assert_backward(*port.pilqr_backward_lanes(tc, A, B), pol_j, val_j, dV_j)


def test_k5_plain_matches_pallas_interpret():
    p, jc, tc = _problem(130, 2, 1)
    ref = _ref("pallas", 130, 2, 1)
    out = cuda_pscan.cuda_pilqr_backward(tc, torch.as_tensor(p["A"]), torch.as_tensor(p["B"]))
    _assert_backward(*out, *ref)
    assert cuda_pscan.cuda_pilqr_backward.launches == 0


@pytest.mark.parametrize("T,lmbda", [
    pytest.param(33, 0.0, id="0.0"),
    pytest.param(33, 0.6, id="0.6"),
    pytest.param(19, 0.6, id="T19-0.6"),
])
def test_k5_plain_reg_matches_pallas_interpret(T, lmbda):
    """At λ = 0 the reference is ``pallas_pilqr_backward`` on the same
    inputs (``Cuu + 0·I`` is ``Cuu``).  T=19 holds a horizon whose T+1
    positions fill less than one warp of K5's block."""
    p, jc, tc = _problem(T, 3, 2)
    pol_j, val_j, dV_j, div_j = _ref("pallas_reg", T, 3, 2, False, lmbda)
    pol, val, dV, div = cuda_pscan.cuda_pilqr_backward_reg(
        tc, torch.as_tensor(p["A"]), torch.as_tensor(p["B"]), lmbda
    )
    assert not bool(div) and not bool(div_j)
    _assert_backward(pol, val, dV, pol_j, val_j, dV_j)


def test_non_pd_step_keeps_each_engines_divergence_semantics():
    """A negative-definite Cuu at one step.  The ``pscan`` engine factors it
    with ``jnp.linalg.cholesky``'s contract: NaN, so it flags divergence, as
    JAX's does.  K5 keeps the TPU kernel's guard (a bad pivot becomes 1): its
    outputs stay finite, unflagged, and equal to the Pallas kernel's."""
    p, jc, tc = _problem(130, 2, 1, non_pd=True)
    A, B = torch.as_tensor(p["A"]), torch.as_tensor(p["B"])
    *_, div_j = _ref("reg", 130, 2, 1, True, 0.0)
    *_, div = port.pilqr_backward_reg(tc, A, B, 0.0)
    assert bool(div) and bool(div_j)

    p, jc, tc = _problem(33, 3, 2, non_pd=True)
    pol_j, val_j, dV_j, div_j = _ref("pallas_reg", 33, 3, 2, True, 0.0)
    pol, val, dV, div = cuda_pscan.cuda_pilqr_backward_reg(
        tc, torch.as_tensor(p["A"]), torch.as_tensor(p["B"]), 0.0
    )
    assert not bool(div) and not bool(div_j)
    for t in (pol.K, pol.kff, val.V, val.v, dV):
        assert bool(torch.isfinite(t).all())
    _assert_backward(pol, val, dV, pol_j, val_j, dV_j)


def test_k5_wrapper_never_falls_back():
    """Off the CPU the wrapper goes to the kernel path, which refuses a
    non-CUDA tensor instead of computing on it; nothing counts as a launch."""
    T, dx, du = 4, 2, 1
    z = lambda *s: torch.zeros(*s, device="meta")  # noqa: E731
    cost = QuadraticCost(z(T + 1, dx, dx), z(T + 1, dx), z(T + 1, du, du), z(T + 1, du),
                         z(T + 1, dx, du), z(T + 1))
    with pytest.raises(ValueError, match="CUDA device"):
        cuda_pscan.cuda_pilqr_backward(cost, z(T, dx, dx), z(T, dx, du))
    assert cuda_pscan.cuda_pilqr_backward.launches == 0


@pytest.mark.parametrize("T,dx,dtype,route", [
    (100, 2, torch.float32, ("cluster", 1)),     # the replan
    (25, 2, torch.float32, ("cluster", 1)),      # the MPC path
    (60, 4, torch.float32, ("cluster", 1)),
    (333, 4, torch.float32, ("cluster", 16)),
    (1000, 4, torch.float32, ("cluster", 16)),
    (19, 3, torch.float64, ("cluster", 1)),
    (130, 2, torch.float64, ("cluster", 16)),
    (1000, 4, torch.float64, ("cluster", 16)),
    (2500, 4, torch.float64, ("cluster", 16)),
    (4095, 4, torch.float32, ("cluster", 16)),   # 256 positions a block
    (4096, 4, torch.float32, ("global", 0)),     # past the cluster's capacity
    (4063, 4, torch.float64, ("cluster", 16)),
    (4064, 4, torch.float64, ("global", 0)),     # past a block's shared memory
])
def test_k5_route_is_a_function_of_the_shape(T, dx, dtype, route):
    """K5's route at chip_smoke.py's shapes and at the cluster route's edges:
    a cluster of C blocks holds T+1 positions at one thread each (at most 256
    a block) with two copies of their elements in a block's shared memory;
    the global-scratch kernel takes the rest."""
    assert cuda_pscan.k5_route(T, dx, dtype) == route
    itemsize = torch.empty((), dtype=dtype).element_size()
    C = route[1] or cuda_pscan.K5_MAX_CLUSTER
    P = -(-(T + 1) // C)
    fits = (P <= cuda_pscan.K5_MAX_THREADS
            and cuda_pscan.k5_cluster_bytes(P, dx, itemsize) <= cuda_pscan.K5_SMEM_BYTES)
    assert fits == (route[0] == "cluster")
