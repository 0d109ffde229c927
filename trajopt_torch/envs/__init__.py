"""Environment registry of the port; ids mirror ``trajopt_tpu.envs``."""

from .base import TrajEnv, clip, make, register, registered, wrap_angle  # noqa: F401
from .cartpole import Cartpole, CartpoleWithCartesianCost  # noqa: F401
