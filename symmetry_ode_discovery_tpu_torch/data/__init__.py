from .datasets import (
    MTODEDataset,
    MultiTimestepReactionDiffusionDataset,
    ODEDataset,
    ReactionDiffusionDataset,
    SimpleLinear,
    data_path,
    get_dataset,
    load_or_generate,
    ode_dt_dict,
)
from .generate import gen_data
from .systems import SYSTEMS, System, dosc, growth, lv, selkov

# the JAX package's DATA_PATH is data_path() here: caches live outside the
# tree, under $SODT_TORCH_DATA_PATH
__all__ = [
    "SYSTEMS", "System", "lv", "dosc", "growth", "selkov", "gen_data", "data_path",
    "load_or_generate", "ode_dt_dict", "get_dataset", "ODEDataset", "MTODEDataset",
    "ReactionDiffusionDataset", "MultiTimestepReactionDiffusionDataset", "SimpleLinear",
]
