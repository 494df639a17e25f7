"""The multi-device layer: seed-axis sharding of the sweeps (mesh.py) and
data-parallel LaLiGAN training (dp.py)."""
