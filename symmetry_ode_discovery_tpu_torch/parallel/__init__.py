"""The multi-device layer: seed-axis sharding of the sweeps (mesh.py) and
data-parallel LaLiGAN training (dp.py)."""

from .mesh import make_mesh, shard_sweep

__all__ = ["make_mesh", "shard_sweep"]
