from .eval_eq import aggregate_results, eval_sindy_coefficients, save_eval_results, sindy_truth

__all__ = ["aggregate_results", "eval_sindy_coefficients", "save_eval_results", "sindy_truth"]
