"""The GP-config sweeps of the port on the card, in one process: plain GP
on dosc/noise20_gp.cfg, growth/noise05_gp.cfg and selkov/noise20_eq_gp.cfg
and EquivGP-r on selkov/noise20_eq_gp_symm.cfg (50 seeds each), and
--gp_select raw on the dosc and growth configs (100 seeds), each through
cli/main_gp.py::main with --seed 0:

    SODT_TORCH_DATA_PATH=build/chip_data python3 tools/card_gp_configs.py [run ...]

``run``: indices into RUNS (default all). The data are the caches under
$SODT_TORCH_DATA_PATH (the JAX package's, regenerated and staged there);
the evaluations go to chiprun_out/card_gp_configs/eval/<save_dir>/, one
JSON line a run with its wall to stdout. Compare each with
``python3 compare_evals.py <eval>/<save_dir> --ref eval_results/<save_dir>
--seeds 0-49`` (0-99 for the raw runs).
"""

import json
import os
import sys
import time

sys.path.insert(0, os.getcwd())
from symmetry_ode_discovery_tpu_torch.cli import main_gp  # noqa: E402

EVAL_ROOT = "chiprun_out/card_gp_configs/eval"
RUNS = [["--config", "dosc/noise20_gp.cfg", "--n_seeds", "50"],
        ["--config", "growth/noise05_gp.cfg", "--n_seeds", "50"],
        ["--config", "selkov/noise20_eq_gp.cfg", "--n_seeds", "50"],
        ["--config", "selkov/noise20_eq_gp_symm.cfg", "--n_seeds", "50"],
        ["--config", "dosc/noise20_gp.cfg", "--gp_select", "raw", "--n_seeds", "100",
         "--save_dir", "gp-rawsel-noise20-dosc"],
        ["--config", "growth/noise05_gp.cfg", "--gp_select", "raw", "--n_seeds", "100",
         "--save_dir", "gp-rawsel-noise05-growth"]]


def main(only=()):
    for i, argv in enumerate(RUNS):
        if only and str(i) not in only:
            continue
        t0 = time.perf_counter()
        main_gp.main(argv + ["--seed", "0", "--eval_root", EVAL_ROOT])
        print(json.dumps({"run": argv, "wall_s": time.perf_counter() - t0}), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
