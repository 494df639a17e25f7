from .datasets import ODEDataset, data_path, load_or_generate
from .generate import gen_data
from .systems import SYSTEMS, System

__all__ = ["ODEDataset", "SYSTEMS", "System", "data_path", "gen_data",
           "load_or_generate"]
