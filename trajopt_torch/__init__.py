"""trajopt-torch: the PyTorch and CUDA port of tpu-trajopt for NVIDIA Hopper.

The package mirrors ``trajopt_tpu`` module for module; every Pallas kernel on a
ported path has a hand-written CUDA C++ counterpart under ``csrc/`` (built by
``kernels/_build.py`` at first use) with a plain PyTorch version beside it.
Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""

import torch as _torch

# The value recursions multiply tiny ill-conditioned matrices over hundreds of
# steps; TF32 (three decimal digits) corrupts them the way bf16 matmul passes
# do on a TPU (trajopt_tpu/__init__.py).  Full-f32 products are mandatory here
# and cost nothing at these shapes; users can override after import.
_torch.set_float32_matmul_precision("highest")
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False

from . import envs  # noqa: E402,F401  (registers the ported environments)
from .envs.base import make, registered  # noqa: E402,F401

__version__ = "0.1.0"
