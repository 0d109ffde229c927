"""The port's belief pieces against trajopt_tpu's, float64 on the CPU.

LightDark and Car: the array methods, ``belief_ekf_step``, the ``EKF`` and
both belief expansions against JAX at rtol 1e-8 on random beliefs (numpy,
seeded), some actions driving LightDark exactly onto its state bound, where
the clip's tie rule sets the Jacobian; the float32-only jitters of the EKF;
the dense ``bsp_backward`` against JAX's; and the plain version of K8
(``core/cuda_belief``, which runs for CPU tensors) against interpret-mode
``pallas_bsp_backward`` (``time_chunk=1``) at rtol 1e-9 with equal flags,
instance 0 of the batch non-PD (``tests/belief_fixtures.py``).  Each JAX
reference is compiled once per module and frozen (``tests/make_torch_refs.py``).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from belief_fixtures import random_belief_problem

import trajopt_torch
import trajopt_tpu
from trajopt_torch.core import belief as tb
from trajopt_torch.core import cuda_belief
from trajopt_torch.core import ekf as tekf
from trajopt_torch.utils.convert import env_from_fields
from trajopt_tpu.core import belief as jb
from trajopt_tpu.core import ekf as jekf
from trajopt_tpu.core.pallas_belief import pallas_bsp_backward

from make_torch_refs import reference

torch.set_num_threads(1)

ENVS = ["LightDark-TO-v0", "Car-TO-v0"]
TOL = dict(rtol=1e-8, atol=1e-12)


def _compiled(f, *args):
    """``jax.jit(f)`` compiled for ``args`` without XLA's backend (LLVM)
    optimizations and its fusion pass: about half the compile time, rounding
    that differs from the default compile's at the 1e-14 level."""
    return jax.jit(f).lower(*args).compile(
        {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True,
         "xla_disable_hlo_passes": "fusion"})
T = 5


@functools.lru_cache(maxsize=None)
def _inputs(name):
    """Beliefs (T+1), actions (T), states, observations and standard normals
    (T); LightDark's first step lands exactly on the state bound x₀ = 7."""
    env = trajopt_tpu.make(name)
    b, a, do = env.belief_dim, env.act_dim, env.obs_dim
    rng = np.random.default_rng(len(name))
    mu = rng.standard_normal((T + 1, b))
    M = rng.standard_normal((T + 1, b, b))
    sig = np.einsum("tij,tkj->tik", M, M) + 0.5 * np.eye(b)
    u = rng.standard_normal((T, a))
    if name.startswith("LightDark"):
        mu[0, 0], u[0, 0] = 6.0, 1.0
    return dict(mu=mu, sig=sig, u=u, z=rng.standard_normal((T, do)),
                eps_dyn=rng.standard_normal((T, env.state_dim)),
                eps_obs=rng.standard_normal((T, do)))


@functools.lru_cache(maxsize=None)
def _jax_outputs(name):
    return _jax_outputs_ref(name), trajopt_tpu.make(name)


@reference(__file__)
def _jax_outputs_ref(name):
    """Every JAX reference of one env, one compiled program."""
    env = trajopt_tpu.make(name)
    filt = jekf.EKF(env)

    def draw(mean, cov, eps):
        return mean + jnp.linalg.cholesky(cov) @ eps

    def run(mu, sig, u, z, eps_dyn, eps_obs):
        m, s = mu[:T], sig[:T]
        xn = jax.vmap(lambda x, uu, e: draw(env.dynamics(x, uu), env.dyn_noise(x, uu), e))(
            m, u, eps_dyn)
        pred = jax.vmap(filt.predict)(m, s, u)
        out = dict(
            dynamics=jax.vmap(env.dynamics)(m, u), observe=jax.vmap(env.observe)(m),
            obs_noise=jax.vmap(env.obs_noise)(m), dyn_noise=env.dyn_noise(m[0], u[0]),
            cost=jax.vmap(env.cost)(m, s, u), step_x=xn,
            step_obs=jax.vmap(lambda x, e: draw(env.observe(x), env.obs_noise(x), e))(xn, eps_obs),
            ekf=jax.vmap(lambda a, b_, c: jekf.belief_ekf_step(env, a, b_, c))(m, s, u),
            predict=pred, innovate=jax.vmap(filt.innovate)(m, s, z),
            inference=jax.vmap(filt.inference)(m, s, u, z),
            dyn=jb.belief_dynamics_expansion(env, m, s, u),
            cost_exp=jb.belief_cost_expansion(env, mu, sig, u),
        )
        return out

    x = _inputs(name)
    args = [jnp.asarray(x[k]) for k in ("mu", "sig", "u", "z", "eps_dyn", "eps_obs")]
    return jax.tree.map(np.asarray, _compiled(run, *args)(*args))


def _port(name):
    jenv = trajopt_tpu.make(name)
    env = env_from_fields(name, dataclasses.asdict(jenv))
    return env, {k: torch.as_tensor(v) for k, v in _inputs(name).items()}


def _close(got, want, tol=TOL, name=""):
    if isinstance(want, tuple):
        for g, w in zip(got, want):
            _close(g, w, tol, name)
        return
    np.testing.assert_allclose(np.asarray(got), want, err_msg=name, **tol)


@pytest.mark.parametrize("name", ENVS)
def test_env_array_methods_match(name):
    ref, jenv = _jax_outputs(name)
    env, x = _port(name)
    m, s, u = x["mu"][:T], x["sig"][:T], x["u"]
    _close(env.dynamics(m, u), ref["dynamics"], name="dynamics")
    _close(env.observe(m), ref["observe"], name="observe")
    _close(env.obs_noise(m), ref["obs_noise"], name="obs_noise")
    _close(env.dyn_noise(m[0], u[0]), ref["dyn_noise"], name="dyn_noise")
    _close(env.cost(m, s, u), ref["cost"], name="cost")
    xn, obs = env.step(None, m, u, (x["eps_dyn"], x["eps_obs"]))
    _close(xn, ref["step_x"], name="step state")
    _close(obs, ref["step_obs"], name="step observation")
    for got, want in zip(env.init(), jenv.init()):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(env.reset_state().numpy(), np.asarray(jenv.reset_state()))
    np.testing.assert_array_equal(env.xlim.numpy(), np.asarray(jenv.xlim))
    np.testing.assert_array_equal(env.ulim.numpy(), np.asarray(jenv.ulim))
    np.testing.assert_array_equal(env.dyn_sigma.numpy(), np.asarray(jenv.dyn_sigma))
    np.testing.assert_array_equal(env.obs_sigma.numpy(), np.asarray(jenv.obs_sigma))
    # the single-launch kernels have LightDark's device functions only
    assert env.supports_belief_tiles == name.startswith("LightDark")
    # the generator draws the same normals the step consumes
    gen = torch.Generator().manual_seed(3)
    xg, og = env.step(gen, m, u)
    gen = torch.Generator().manual_seed(3)
    eps = (torch.randn(m.shape, generator=gen, dtype=m.dtype),
           torch.randn((T, env.obs_dim), generator=gen, dtype=m.dtype))
    xe, oe = env.step(None, m, u, eps)
    assert torch.equal(xg, xe) and torch.equal(og, oe)


@pytest.mark.parametrize("name", ENVS)
def test_belief_ekf_step_and_filter_match(name):
    ref, _ = _jax_outputs(name)
    env, x = _port(name)
    m, s, u, z = x["mu"][:T], x["sig"][:T], x["u"], x["z"]
    _close(tekf.belief_ekf_step(env, m, s, u), ref["ekf"], name="belief_ekf_step")
    filt = tekf.EKF(env)
    _close(filt.predict(m, s, u), ref["predict"], name="predict")
    _close(filt.innovate(m, s, z), ref["innovate"], name="innovate")
    _close(filt.inference(m, s, u, z), ref["inference"], name="inference")


@pytest.mark.parametrize("name", ENVS)
def test_belief_expansions_match(name):
    ref, _ = _jax_outputs(name)
    env, x = _port(name)
    dyn = tb.belief_dynamics_expansion(env, x["mu"][:T], x["sig"][:T], x["u"])
    cost = tb.belief_cost_expansion(env, x["mu"], x["sig"], x["u"])
    for field, want in zip(dyn._fields, ref["dyn"]):
        _close(getattr(dyn, field), want, name=field)
    for field, want in zip(cost._fields, ref["cost_exp"]):
        _close(getattr(cost, field), want, name=field)
    # a batch axis in front of time gives the same blocks
    dyn2 = tb.belief_dynamics_expansion(env, x["mu"][None, :T].expand(2, T, -1),
                                        x["sig"][None, :T].expand(2, T, -1, -1),
                                        x["u"][None].expand(2, T, -1))
    torch.testing.assert_close(dyn2.U[1], dyn.U, rtol=0, atol=0)


def test_clip_second_derivative_matches_jax():
    """The belief expansion differentiates Jacobians of clipped dynamics: the
    clip's tie rule (slope ½ at a bound) holds for first derivatives, and
    second derivatives pass through it."""
    from trajopt_torch.envs.base import clip

    x0 = np.array([-2.0, -1.5, 0.5, 2.0, 2.5])     # x0³ on, inside and outside ±8

    def jf(v):
        return jnp.clip(v * v * v, -8.0, 8.0)

    lo, hi = torch.tensor(-8.0, dtype=torch.float64), torch.tensor(8.0, dtype=torch.float64)

    def tf(v):
        return clip(v * v * v, lo, hi)

    for order, ties in ((1, (0.5 * 12.0, 0.5 * 12.0)), (2, (0.5 * -12.0, 0.5 * 12.0))):
        jd, td = jf, tf
        for _ in range(order):
            jd, td = jax.grad(jd), torch.func.grad(td)
        want = np.array([float(jd(v)) for v in x0])
        got = np.array([float(td(torch.tensor(v, dtype=torch.float64))) for v in x0])
        np.testing.assert_allclose(got, want, rtol=1e-12, err_msg=f"order {order}")
        np.testing.assert_allclose(got[[0, 3]], ties, rtol=1e-12)


def test_float32_jitters_match():
    """``_inv`` and ``_psd_floor`` add their relative jitter in float32 only."""
    rng = np.random.default_rng(5)
    M = rng.standard_normal((4, 2, 2))
    M = np.einsum("nij,nkj->nik", M, M) + 1e-3 * np.eye(2)
    for dtype, jdtype in ((torch.float64, "float64"), (torch.float32, "float32")):
        got_inv = tekf._inv(torch.as_tensor(M, dtype=dtype))
        got_floor = tekf._psd_floor(torch.as_tensor(M, dtype=dtype))
        want_inv, want_floor = _jitter_ref(jdtype)
        tol = TOL if dtype == torch.float64 else dict(rtol=1e-5, atol=1e-6)
        _close(got_inv, np.asarray(want_inv), tol, "inv")
        _close(got_floor, np.asarray(want_floor), tol, "floor")
        assert got_floor.dtype == dtype
        assert torch.equal(got_floor, torch.as_tensor(M, dtype=dtype)) == (dtype == torch.float64)


@reference(__file__)
def _jitter_ref(jdtype):
    rng = np.random.default_rng(5)
    M = rng.standard_normal((4, 2, 2))
    M = jnp.asarray(np.einsum("nij,nkj->nik", M, M) + 1e-3 * np.eye(2), jdtype)
    return jax.vmap(jekf._inv)(M), jax.vmap(jekf._psd_floor)(M)


N, TB = 5, 6
LAMS = (0.0, 3.7, 0.0, 3.7, 0.0)


@functools.lru_cache(maxsize=None)
def _belief_problem(b, bad):
    cost, dyn = random_belief_problem(1, N, TB, b=b, bad_instance=bad)
    return cost, dyn, jnp.asarray(LAMS)


def _to_torch(cost, dyn):
    return (tb.BeliefCostExpansion(*(torch.as_tensor(np.array(v)) for v in cost)),
            tb.BeliefDynamicsExpansion(*(torch.as_tensor(np.array(v)) for v in dyn)))


def _outputs(out):
    policy, *rest = out
    return [np.asarray(policy.K), np.asarray(policy.kff)] + [np.asarray(r) for r in rest]


@reference(__file__)
def _scan_ref(b, bad, reg):
    cost, dyn, lam = _belief_problem(b, bad)
    return _outputs(_compiled(jax.vmap(lambda c, d, l: jb.bsp_backward(c, d, l, reg)),
                              cost, dyn, lam)(cost, dyn, lam))


@reference(__file__)
def _pallas_ref(reg):
    cost, dyn, lam = _belief_problem(2, True)
    return _outputs(_compiled(
        lambda c, d, lm: pallas_bsp_backward(c, d, lm, reg, time_chunk=1, interpret=True),
        cost, dyn, lam)(cost, dyn, lam))


@pytest.mark.parametrize("reg", [1, 2])
def test_bsp_backward_matches_jax(reg):
    cost, dyn, lam = _belief_problem(2, True)
    want = _scan_ref(2, True, reg)
    got = _outputs(tb.bsp_backward(*_to_torch(cost, dyn), torch.tensor(LAMS, dtype=torch.float64), reg))
    for name, g, w in zip(("K", "kff", "S", "s", "tau", "dS"), got, want):
        np.testing.assert_allclose(g, w, rtol=1e-9, atol=1e-9, err_msg=name)
    np.testing.assert_array_equal(got[6], want[6])
    assert got[6][0] and not got[6][1:].any()


@pytest.mark.parametrize("reg", [1, 2])
def test_k8_plain_matches_pallas_interpret(reg):
    """b = 2: interpret-mode Pallas, instance 0 non-PD (the guard keeps it
    finite and flags it in both)."""
    cost, dyn, lam = _belief_problem(2, True)
    want = _pallas_ref(reg)
    got = _outputs(cuda_belief.cuda_bsp_backward(*_to_torch(cost, dyn), torch.tensor(LAMS, dtype=torch.float64),
                                                 reg))
    for name, g, w in zip(("K", "kff", "S", "s", "tau", "dS"), got, want):
        np.testing.assert_allclose(g, w, rtol=1e-9, atol=1e-9, err_msg=name)
    np.testing.assert_array_equal(got[6], want[6])
    assert got[6][0] and not got[6][1:].any()


def test_k8_plain_b4_matches_scan():
    """b = 4 (Car's dims), every instance PD: the guard never acts, so K8's
    plain version equals JAX's scan recursion."""
    cost, dyn, lam = _belief_problem(4, False)
    want = _scan_ref(4, False, 2)
    got = _outputs(cuda_belief.cuda_bsp_backward(*_to_torch(cost, dyn), torch.tensor(LAMS, dtype=torch.float64),
                                                 2))
    for name, g, w in zip(("K", "kff", "S", "s", "tau", "dS"), got, want):
        np.testing.assert_allclose(g, w, rtol=1e-9, atol=1e-9, err_msg=name)
    assert not got[6].any() and not want[6].any()
