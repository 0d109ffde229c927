"""Parity of the port's rollouts with trajopt_tpu's, float64 on the CPU: the
plain versions of K2 (all-α returns) and K3 (per-instance selected α) against
the interpret-mode ``rollout_all_alphas_pallas``/``pallas_rollout_selected``
and per-lane JAX rollouts, on Cartpole and Pendulum, and the scan engine's
``rollout_tracking`` against JAX's; the env kinds and fields the kernels
take (``env_kernel_args``).  The JAX references
(and the JAX rollouts that make the inputs) are frozen
(``tests/make_torch_refs.py``)."""

import dataclasses
import hashlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import trajopt_torch
import trajopt_tpu
from trajopt_torch.core.cuda_lqr import lane_pad, pad_lanes
from trajopt_torch.core.cuda_rollout import (
    cuda_rollout_returns,
    cuda_rollout_selected,
    env_kernel_args,
    pack_rollout,
    unpack_selected,
)
from trajopt_torch.core.types import LinearPolicy
from trajopt_torch.solvers.common import make_weighting, rollout_tracking
from trajopt_torch.utils.convert import env_from_fields
from trajopt_tpu.core import pallas_rollout as jax_rollout
from trajopt_tpu.core.types import LinearPolicy as JaxPolicy
from trajopt_tpu.solvers.common import make_weighting as jax_weighting
from trajopt_tpu.solvers.common import rollout_tracking as jax_rollout_tracking

from make_torch_refs import frozen, reference

torch.set_num_threads(1)

TOL = dict(rtol=1e-10, atol=1e-12)


def _problem(jenv, N, T, seed, scale=0.3):
    """Random gains and a reference rolled out with the JAX env; large
    feedforwards so that some actions saturate."""
    key = hashlib.sha256(repr((jenv, N, T, seed, scale)).encode()).hexdigest()[:16]
    return frozen(__file__, f"problem-{key}", lambda: _problem_live(jenv, N, T, seed, scale))


def _problem_live(jenv, N, T, seed, scale):
    rng = np.random.default_rng(seed)
    dx, du = jenv.dm_state, jenv.dm_act
    K = scale * rng.standard_normal((N, T, du, dx))
    kff = 20.0 * rng.standard_normal((N, T, du))
    uref = scale * rng.standard_normal((N, T, du))
    x = np.asarray(jenv.x0) + 0.1 * rng.standard_normal((N, dx))
    step = jax.jit(jax.vmap(jenv.dynamics))
    xs = [x]
    for t in range(T):
        x = np.asarray(step(jnp.asarray(x), jnp.asarray(uref[:, t])))
        xs.append(x)
    return K, kff, np.stack(xs, axis=1), uref


def _envs(name, kw):
    jenv = trajopt_tpu.make(name, **kw)
    return jenv, env_from_fields(name, dataclasses.asdict(jenv))


def _t(*arrays):
    return [torch.as_tensor(a) for a in arrays]


@pytest.mark.parametrize(
    "name,kw,activation",
    [
        ("Cartpole-TO-v0", {}, None),
        ("Cartpole-TO-v1", {}, None),
        ("Cartpole-TO-v0", {"slew_rate": True}, {"mult": 0.5, "shift": 4.0}),
        ("Pendulum-TO-v0", {}, None),
        ("Pendulum-TO-v1", {}, None),
        ("Pendulum-TO-v0", {"slew_rate": True}, {"mult": 0.5, "shift": 4.0}),
    ],
)
def test_k2_k3_plain_match_pallas_interpret(name, kw, activation):
    """K2's returns on every α and K3's rollout of each α, against one
    interpret-mode call of each Pallas kernel: phase B runs every (instance,
    α) pair at once, one lane each."""
    jenv, tenv = _envs(name, kw)
    N, T = 4, 8
    alphas = (1.0, 0.5, 0.1)
    K, kff, xref, uref = _problem(jenv, N, T, seed=0)
    ret_j, ok_j, s_j, a_j, r_j = _k2_k3_ref(name, kw, activation)
    np.testing.assert_allclose(r_j.T, ret_j, **TOL)

    n_pad = lane_pad(N)
    streams = pack_rollout(*_t(K, kff, xref, uref), n_pad)
    w = make_weighting(T, activation, device="cpu", dtype=torch.float64)
    alphas_t = torch.tensor(alphas, dtype=torch.float64)
    ret_l, ok_l = cuda_rollout_returns(tenv, *streams, w, alphas_t)
    np.testing.assert_allclose(ret_l[:, :N].T.numpy(), ret_j, **TOL)
    np.testing.assert_array_equal(ok_l[:, :N].T.numpy(), ok_j)
    assert np.any(np.abs(a_j) == jenv.umax[0])
    for i, a in enumerate(alphas):
        al = pad_lanes(torch.full((N,), a, dtype=torch.float64), n_pad)
        xs_l, us_l, xT_l, r_l = cuda_rollout_selected(tenv, *streams, w, al)
        states, actions = unpack_selected(xs_l, us_l, xT_l, N)
        np.testing.assert_allclose(states.numpy(), s_j[i], **TOL)
        np.testing.assert_allclose(actions.numpy(), a_j[i], **TOL)
        np.testing.assert_allclose(r_l[:N].numpy(), ret_j[:, i], **TOL)


@reference(__file__)
def _k2_k3_ref(name, kw, activation):
    """K2's returns on every α and K3's rollout of each α (all pairs on their
    own lanes), interpret-mode Pallas."""
    jenv = _envs(name, kw)[0]
    N, T = 4, 8
    alphas = (1.0, 0.5, 0.1)
    nA = len(alphas)
    K, kff, xref, uref = _problem(jenv, N, T, seed=0)
    w_j = jax_weighting(T, activation)
    packed_j = jax_rollout.pack_rollout(*(jnp.asarray(a) for a in (K, kff, xref, uref)))
    ret_jl, ok_jl = jax_rollout.pallas_rollout_returns(jenv, packed_j, w_j, alphas,
                                                       time_chunk=1, interpret=True)
    ret_j = np.asarray(ret_jl).reshape(nA, -1)[:, :N].T
    ok_j = np.asarray(ok_jl).reshape(nA, -1)[:, :N].T > 0
    # phase B: lane i·N + n rolls instance n out at alphas[i]
    rep = [np.concatenate([a] * nA) for a in (K, kff, xref, uref)]
    packed_rep = jax_rollout.pack_rollout(*(jnp.asarray(a) for a in rep))
    alpha_rep = np.repeat(alphas, N)
    lanes = np.zeros(packed_rep["K"].shape[2:])
    lanes.reshape(-1)[: nA * N] = alpha_rep
    s_jl, a_jl, xT_jl, r_jl = jax_rollout.pallas_rollout_selected(
        jenv, packed_rep, w_j, jnp.asarray(lanes), time_chunk=1, interpret=True)
    s_j, a_j = (np.asarray(x).reshape(nA, N, *x.shape[1:]) for x in
                jax_rollout.unpack_selected(s_jl, a_jl, xT_jl, nA * N))
    r_j = np.asarray(r_jl).reshape(-1)[: nA * N].reshape(nA, N)
    return ret_j, ok_j, s_j, a_j, r_j


def test_k3_plain_selected_alpha_per_lane():
    """Phase B with a different α per instance equals per-instance JAX
    rollout_tracking (the reference of the scan engine)."""
    jenv, tenv = _envs("Cartpole-TO-v0", {})
    N, T = 5, 8
    K, kff, xref, uref = _problem(jenv, N, T, seed=1)
    alphas = np.array([1.0, 0.31, 0.1, 0.031, 0.001])
    n_pad = lane_pad(N)
    w = make_weighting(T, None, device="cpu", dtype=torch.float64)
    xs_l, us_l, xT_l, r_l = cuda_rollout_selected(
        tenv, *pack_rollout(*_t(K, kff, xref, uref), n_pad), w,
        pad_lanes(torch.as_tensor(alphas), n_pad),
    )
    states, actions = unpack_selected(xs_l, us_l, xT_l, N)
    w_j = jax_weighting(T, None)

    def one(K1, kff1, xr, ur, a):
        return jax_rollout_tracking(jenv, JaxPolicy(K=K1, kff=kff1), a, xr[0], xr, ur, w_j)

    s_j, a_j, c_j = frozen(__file__, "per-lane", lambda: jax.jit(jax.vmap(one))(
        *(jnp.asarray(x) for x in (K, kff, xref, uref, alphas))))
    np.testing.assert_allclose(states.numpy(), np.asarray(s_j), **TOL)
    np.testing.assert_allclose(actions.numpy(), np.asarray(a_j), **TOL)
    np.testing.assert_allclose(r_l[:N].numpy(), np.sum(c_j, axis=1), rtol=1e-10)


@pytest.mark.parametrize("name", ["Pendulum-TO-v0", "Pendulum-TO-v1"])
def test_k3_plain_selected_alpha_per_lane_pendulum(name):
    """Phase B with a different α per instance on Pendulum equals
    per-instance JAX rollout_tracking, as on Cartpole above."""
    jenv, tenv = _envs(name, {"dt": 0.05})
    N, T = 5, 8
    K, kff, xref, uref = _problem(jenv, N, T, seed=1)
    alphas = np.array([1.0, 0.31, 0.1, 0.031, 0.001])
    n_pad = lane_pad(N)
    w = make_weighting(T, None, device="cpu", dtype=torch.float64)
    xs_l, us_l, xT_l, r_l = cuda_rollout_selected(
        tenv, *pack_rollout(*_t(K, kff, xref, uref), n_pad), w,
        pad_lanes(torch.as_tensor(alphas), n_pad),
    )
    states, actions = unpack_selected(xs_l, us_l, xT_l, N)
    w_j = jax_weighting(T, None)

    def one(K1, kff1, xr, ur, a):
        return jax_rollout_tracking(jenv, JaxPolicy(K=K1, kff=kff1), a, xr[0], xr, ur, w_j)

    s_j, a_j, c_j = frozen(__file__, f"per-lane-{name}", lambda: jax.jit(jax.vmap(one))(
        *(jnp.asarray(x) for x in (K, kff, xref, uref, alphas))))
    assert np.any(np.abs(actions.numpy()) == jenv.umax[0])
    np.testing.assert_allclose(states.numpy(), np.asarray(s_j), **TOL)
    np.testing.assert_allclose(actions.numpy(), np.asarray(a_j), **TOL)
    np.testing.assert_allclose(r_l[:N].numpy(), np.sum(c_j, axis=1), rtol=1e-10)


@pytest.mark.parametrize("name,kw,kind", [
    ("Cartpole-TO-v0", {}, 0), ("Cartpole-TO-v1", {}, 1), ("Pendulum-TO-v0", {}, 2),
    ("Pendulum-TO-v1", {}, 3), ("Pendulum-TO-v0", {"dt": 0.05, "periodic": True}, 2),
    ("Pendulum-TO-v1", {"slew_rate": True, "umax": (2.5,)}, 3),
])
def test_env_kernel_args_gives_kind_and_fields(name, kw, kind):
    """The C entry points' env kind (csrc/envs.cuh ``with_env``) and the env's
    fields as EnvParams, the unused tail zero."""
    env = trajopt_torch.make(name, **kw)
    got, p = env_kernel_args(env, env.dm_state, env.dm_act)
    assert got == kind
    assert p.dt == env.dt
    for field, size in (("g", 8), ("gw", 8), ("uw", 4), ("umax", 4), ("xmax", 8)):
        vals = tuple(float(v) for v in getattr(env, field))
        assert tuple(getattr(p, field)) == vals + (0.0,) * (size - len(vals))
    assert (p.periodic, p.slew_rate) == (int(env.periodic), int(env.slew_rate))
    with pytest.raises(ValueError, match="streams have"):
        env_kernel_args(env, env.dm_state + 1, env.dm_act)


@pytest.mark.parametrize("name", ["LQR-TO-v0", "Robot-TO-v0"])
def test_env_kernel_args_refuses_envs_without_device_functions(name):
    env = trajopt_torch.make(name)
    with pytest.raises(ValueError, match="no CUDA kernel is written for"):
        env_kernel_args(env, env.dm_state, env.dm_act)


@pytest.mark.parametrize("name", ["Cartpole-TO-v0", "Cartpole-TO-v1"])
def test_scan_rollout_tracking_matches_jax(name):
    jenv, tenv = _envs(name, {})
    N, T = 3, 10
    K, kff, xref, uref = _problem(jenv, N, T, seed=2)
    alphas = np.array([1.0, 0.5, 0.1])
    w_j = jax_weighting(T, {"discount": 0.97})
    w_t = make_weighting(T, {"discount": 0.97}, device="cpu", dtype=torch.float64)
    np.testing.assert_allclose(w_t.numpy(), np.asarray(w_j), rtol=1e-15)

    def one(K1, kff1, xr, ur, a):
        return jax_rollout_tracking(jenv, JaxPolicy(K=K1, kff=kff1), a, xr[0], xr, ur, w_j)

    s_j, a_j, c_j = frozen(__file__, f"tracking-{name}", lambda: jax.jit(jax.vmap(one))(
        jnp.asarray(K), jnp.asarray(kff), jnp.asarray(xref), jnp.asarray(uref),
        jnp.asarray(alphas)))
    Kt, kfft, xt, ut = _t(K, kff, xref, uref)
    s_t, a_t, c_t = rollout_tracking(
        tenv, LinearPolicy(K=Kt, kff=kfft), torch.as_tensor(alphas), xt[:, 0], xt, ut, w_t
    )
    np.testing.assert_allclose(s_t.numpy(), np.asarray(s_j), **TOL)
    np.testing.assert_allclose(a_t.numpy(), np.asarray(a_j), **TOL)
    np.testing.assert_allclose(c_t.numpy(), np.asarray(c_j), rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("Np,refusal", [(16, "multiple of 32"), (48, "multiple of 32"),
                                        (1000, "multiple of 32"), (64, "CUDA device")])
@pytest.mark.parametrize("phase", ["K2", "K3"])
def test_rollout_wrappers_take_whole_lane_groups(phase, Np, refusal):
    """As K1's and K4's wrappers: the staged K2/K3 take whole groups of
    instances, so a device batch whose lane count is not lane_pad's multiple
    of 32 is refused before any launch; a padded one passes on to the device
    checks (here: meta tensors)."""
    tenv = env_from_fields("Cartpole-TO-v0", {})
    T = 3
    z = lambda *s: torch.zeros(*s, device="meta")  # noqa: E731
    streams = (z(T, 4, Np), z(T, 1, Np), z(T, 4, Np), z(T, 1, Np))
    wrapper = cuda_rollout_returns if phase == "K2" else cuda_rollout_selected
    alphas = z(3) if phase == "K2" else z(Np)
    launches = wrapper.launches
    with pytest.raises(ValueError, match=refusal):
        wrapper(tenv, *streams, z(T + 1), alphas)
    assert wrapper.launches == launches
