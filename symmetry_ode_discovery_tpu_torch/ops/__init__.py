from .integrators import odeint, solve_ode_batch
from .library import FunctionLibrary
from .lie import expm, so

__all__ = ["FunctionLibrary", "so", "expm", "odeint", "solve_ode_batch"]
