from .siged import LBFGSHParams, train_sindy_lbfgs

__all__ = ["LBFGSHParams", "train_sindy_lbfgs"]
