"""The single-launch solve wrappers (K14 eLQR solve, K9 BSP solve, K10
belief-MPC episode) refuse a tensor on a device that is neither the CPU nor
CUDA (here: meta) before any build or launch: no fallback to the plain
version, no launch counted.  Torch only, no JAX reference."""

import pytest
import torch

import trajopt_torch
from trajopt_torch.core import cuda_bsp, cuda_elqr
from trajopt_torch.kernels import _build

torch.set_num_threads(1)


def _meta(*shape):
    return torch.zeros(*shape, device="meta")


def _launches():
    return (cuda_elqr.cuda_elqr_solve.launches, cuda_bsp.cuda_bsp_solve.launches,
            cuda_bsp.cuda_bsp_episode.launches)


@pytest.mark.parametrize("kernel", ["K14", "K9", "K10"])
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
        elif kernel == "K9":
            env = trajopt_torch.make("LightDark-TO-v0")
            cfg = cuda_bsp.bsp_config(env, T, 2)
            cuda_bsp.cuda_bsp_solve(env, cfg, _meta(2), _meta(2, 2))
        else:
            env = trajopt_torch.make("LightDark-TO-v0")
            cfg = cuda_bsp.bsp_config(env, T, 2, steps)
            cuda_bsp.cuda_bsp_episode(env, cfg, _meta(2), _meta(2), _meta(steps, 2),
                                      _meta(steps, 2))
    assert _launches() == before
