"""The single-launch solve wrappers (K14 eLQR solve, K9 BSP solve, K10
belief-MPC episode), the eLQR sweep and rollout wrappers (K11 cost-to-come,
K12 cost-to-go, K13 evaluation rollout) and the GPS dual chain's wrappers
(K6 backward, K7 forward KL) and the belief-value backward (K8) refuse a
tensor on a device that is neither the CPU nor CUDA (here: meta) before any
build or launch: no fallback to the plain version, no launch counted.  Torch only, no JAX reference."""

import pytest
import torch

import trajopt_torch
from trajopt_torch.core import cuda_belief, cuda_bsp, cuda_elqr, cuda_gps
from trajopt_torch.kernels import _build

torch.set_num_threads(1)


def _meta(*shape):
    return torch.zeros(*shape, device="meta")


def _gps_packed(T, dx, du, N):
    """K6/K7's packed streams (cuda_gps.pack_gps's layout) on the meta device."""
    shapes = dict(cxx=(T, dx * dx, N), cx=(T, dx, N), cuu=(T, du * du, N), cu=(T, du, N),
                  cxu=(T, dx * du, N), c0=(T, 1, N), A=(T, dx * dx, N), B=(T, dx * du, N),
                  c=(T, dx, N), sigd=(T, dx * dx, N), Ko=(T, du * dx, N), ko=(T, du, N),
                  sigo=(T, du * du, N), vT=(dx * dx, N), vvT=(dx, N), v0T=(1, N),
                  mu0=(dx, N), sig0=(dx * dx, N))
    return {k: _meta(*v) for k, v in shapes.items()}


def _belief_packed(T, b, a, N):
    """K8's packed streams (cuda_belief.pack_belief's layout) on the meta device."""
    bb = b * b
    shapes = dict(Q=b * b, q=b, R=a * a, r=a, P=b * a, p=bb, F=b * b, G=b * a, X=bb * b,
                  Y=bb * bb, Z=bb * a, T=bb * b, U=bb * bb, V=bb * a)
    packed = {k: _meta(T, n, N) for k, n in shapes.items()}
    packed.update(QT=_meta(b * b, N), qT=_meta(b, N), pT=_meta(bb, N))
    return packed


def _launches():
    return (cuda_elqr.cuda_elqr_solve.launches, cuda_elqr.cuda_elqr_forward.launches,
            cuda_elqr.cuda_elqr_backward.launches, cuda_bsp.cuda_bsp_solve.launches,
            cuda_bsp.cuda_bsp_episode.launches, cuda_elqr.cuda_elqr_rollout.launches,
            cuda_gps.cuda_gps_backward_packed.launches,
            cuda_gps.cuda_gps_forward_kl_packed.launches,
            cuda_belief.cuda_bsp_backward_packed.launches)


@pytest.mark.parametrize("kernel", ["K14", "K11", "K12", "K9", "K10", "K6", "K7", "K13", "K8"])
def test_solve_wrappers_refuse_non_cuda_devices(kernel, monkeypatch):
    def no_build(*args, **kw):
        raise AssertionError(f"{kernel}: a kernel was built or loaded for a meta tensor")

    monkeypatch.setattr(_build, "build", no_build)
    monkeypatch.setattr(_build, "load", no_build)
    before = _launches()
    T, steps = 5, 3
    with pytest.raises(ValueError, match="CUDA device"):
        if kernel == "K14":
            env = trajopt_torch.make("Cartpole-TO-v0")
            cuda_elqr.cuda_elqr_solve(env, _meta(T, 1, 2), _meta(4, 2), 2)
        elif kernel == "K11":
            env = trajopt_torch.make("Cartpole-TO-v0")
            cuda_elqr.cuda_elqr_forward(env, _meta(T, 4, 2), _meta(T, 1, 2),
                                        _meta(T + 1, 16, 2), _meta(T + 1, 4, 2), _meta(4, 2))
        elif kernel == "K12":
            env = trajopt_torch.make("Cartpole-TO-v0")
            cuda_elqr.cuda_elqr_backward(env, _meta(T, 4, 2), _meta(T, 1, 2),
                                         _meta(T + 1, 16, 2), _meta(T + 1, 4, 2), _meta(4, 2))
        elif kernel == "K9":
            env = trajopt_torch.make("LightDark-TO-v0")
            cfg = cuda_bsp.bsp_config(env, T, 2)
            cuda_bsp.cuda_bsp_solve(env, cfg, _meta(2), _meta(2, 2))
        elif kernel == "K6":
            cuda_gps.cuda_gps_backward_packed(_gps_packed(T, 2, 1, 3), _meta(T, 1, 3))
        elif kernel == "K7":
            cuda_gps.cuda_gps_forward_kl_packed(_gps_packed(T, 2, 1, 3), _meta(T, 2, 3),
                                                _meta(T, 1, 3), _meta(T, 1, 3))
        elif kernel == "K8":
            cuda_belief.cuda_bsp_backward_packed(_belief_packed(T, 2, 2, 3), _meta(3), 1)
        elif kernel == "K13":
            env = trajopt_torch.make("Cartpole-TO-v0")
            cuda_elqr.cuda_elqr_rollout(env, _meta(T, 4, 2), _meta(T, 1, 2), _meta(4, 2))
        else:
            env = trajopt_torch.make("LightDark-TO-v0")
            cfg = cuda_bsp.bsp_config(env, T, 2, steps)
            cuda_bsp.cuda_bsp_episode(env, cfg, _meta(2), _meta(2), _meta(steps, 2),
                                      _meta(steps, 2))
    assert _launches() == before
