from .sindy import SINDyConfig, SINDyState, get_Xi, init_sindy, set_threshold, sindy_forward
from .wsindy import WSINDyMatrices, wsindy_solve_step

__all__ = ["SINDyConfig", "SINDyState", "init_sindy", "sindy_forward", "get_Xi",
           "set_threshold", "WSINDyMatrices", "wsindy_solve_step"]
