"""Environment registry of the port; ids mirror ``trajopt_tpu.envs``."""

from .base import BeliefEnv, TrajEnv, clip, make, register, registered, wrap_angle  # noqa: F401
from .car import Car  # noqa: F401
from .cartpole import Cartpole, CartpoleWithCartesianCost  # noqa: F401
from .lightdark import LightDark  # noqa: F401
from .lqr import LQRv0, LQRv1, LQRv2  # noqa: F401
from .pendulum import Pendulum, PendulumWithCartesianCost  # noqa: F401
from .robot import Robot  # noqa: F401
