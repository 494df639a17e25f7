from .eval_eq import aggregate_results, eval_sindy_coefficients, sindy_truth

__all__ = ["aggregate_results", "eval_sindy_coefficients", "sindy_truth"]
