"""Experiment tracking: an MLflow-compatible run logger with a JSONL sink.

The port's copy of the JAX package's ``stonkgs_tpu/utils/logging.py``:
params and step metrics go to ``{log_dir}/{experiment}-{run_name}.jsonl``
(and to stdout), one JSON record a line, and through to mlflow only when
a tracking URI is given and mlflow imports.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, Optional


def _try_mlflow(tracking_uri: Optional[str]):
    if tracking_uri is None:
        return None
    try:
        import mlflow
    except ImportError:
        return None
    mlflow.set_tracking_uri(tracking_uri)
    return mlflow


class RunLogger:
    """Per-run logger: params and step metrics; JSONL, optionally mlflow."""

    def __init__(
        self,
        log_dir: Optional[str] = None,
        experiment: str = "default",
        run_name: Optional[str] = None,
        tracking_uri: Optional[str] = None,
        stdout: bool = True,
    ):
        self.experiment = experiment
        self.run_name = run_name or time.strftime("%Y%m%d-%H%M%S")
        self.stdout = stdout
        self._fh = None
        if log_dir:
            os.makedirs(log_dir, exist_ok=True)
            self._fh = open(os.path.join(log_dir, f"{experiment}-{self.run_name}.jsonl"), "a")
        self._mlflow = _try_mlflow(tracking_uri)
        if self._mlflow is not None:
            self._mlflow.set_experiment(experiment)
            self._mlflow.start_run(run_name=self.run_name)

    def _emit(self, record: Dict[str, Any]) -> None:
        record["ts"] = time.time()
        if self._fh:
            self._fh.write(json.dumps(record) + "\n")
            self._fh.flush()
        if self.stdout:
            print(json.dumps(record), flush=True)

    def log_param(self, key: str, value: Any) -> None:
        """Record a run parameter (as ``mlflow.log_param``)."""
        self._emit({"type": "param", "key": key, "value": str(value)})
        if self._mlflow is not None:
            self._mlflow.log_param(key, value)

    def log_metric(self, key: str, value: float, step: Optional[int] = None) -> None:
        """Record one metric value at a step."""
        self._emit({"type": "metric", "key": key, "value": float(value), "step": step})
        if self._mlflow is not None:
            self._mlflow.log_metric(key, value, step=step)

    def log_metrics(self, metrics: Dict[str, float], step: Optional[int] = None) -> None:
        """Record a dict of metrics at a step."""
        for k, v in metrics.items():
            self.log_metric(k, v, step)

    def close(self) -> None:
        """Close the JSONL sink (and end the mlflow run, if one is active)."""
        if self._fh:
            self._fh.close()
            self._fh = None
        if self._mlflow is not None:
            self._mlflow.end_run()
            self._mlflow = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
