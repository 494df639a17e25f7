"""Metrics logging: one JSON object per step in <root>/<name>/metrics.jsonl
and the run's flags in <root>/<name>/params.json.

The port's copy of symmetry_ode_discovery_tpu/utils/metrics.py without its
wandb mirror (the card's machine has no network). The root is the caller's:
the CLI puts it under --save_root, so a run writes nothing into the working
tree.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, Optional


class MetricsLogger:
    def __init__(self, name: str, config: Optional[Dict[str, Any]] = None, root: str = "runs"):
        self.dir = os.path.join(root, name)
        os.makedirs(self.dir, exist_ok=True)
        self._f = open(os.path.join(self.dir, "metrics.jsonl"), "a")
        self._step = 0
        self._t0 = time.time()
        if config is not None:
            with open(os.path.join(self.dir, "params.json"), "w") as f:
                json.dump(dict(config), f, indent=2, default=str)

    def log(self, metrics: Dict[str, Any], step: Optional[int] = None) -> None:
        if step is None:
            step = self._step
        self._step = step + 1
        rec = {"step": step, "t": round(time.time() - self._t0, 3)}
        for k, v in metrics.items():
            try:
                rec[k] = float(v)
            except (TypeError, ValueError):
                rec[k] = str(v)
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()

    def finish(self) -> None:
        self._f.close()


def load_metrics(name: str, root: str = "runs"):
    """A run's metrics.jsonl as a list of dicts."""
    with open(os.path.join(root, name, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f if line.strip()]
