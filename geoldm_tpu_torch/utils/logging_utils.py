"""Metric logging: JSONL always; wandb when available and enabled (copy of
``geoldm_tpu/utils/logging_utils.py``).

The reference hard-wires wandb (main_qm9.py:177-185, train_test.py:91-94).
Here wandb is optional (guarded import); every metric also lands in a
line-oriented JSONL file so runs are inspectable without any service.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, Optional

try:
    import wandb as _wandb

    WANDB_AVAILABLE = True
except ModuleNotFoundError:
    _wandb = None
    WANDB_AVAILABLE = False


class MetricLogger:
    def __init__(
        self,
        outdir: Optional[str] = None,
        use_wandb: bool = False,
        project: str = "geoldm_tpu_torch",
        exp_name: str = "run",
        config: Optional[dict] = None,
        online: bool = False,
    ):
        self.outdir = outdir
        self._file = None
        if outdir:
            os.makedirs(outdir, exist_ok=True)
            self._file = open(os.path.join(outdir, "metrics.jsonl"), "a")
        self._wandb_run = None
        if use_wandb and WANDB_AVAILABLE:
            mode = "online" if online else "offline"
            self._wandb_run = _wandb.init(
                project=project, name=exp_name, config=config or {}, mode=mode
            )

    def log(self, metrics: Dict[str, Any], step: Optional[int] = None) -> None:
        record = {"_time": time.time()}
        if step is not None:
            record["_step"] = int(step)
        for k, v in metrics.items():
            try:
                record[k] = float(v)
            except (TypeError, ValueError):
                record[k] = v
        if self._file:
            self._file.write(json.dumps(record) + "\n")
            self._file.flush()
        if self._wandb_run is not None:
            # Never pass ``step`` to wandb: per-batch logs (no step) advance
            # wandb's auto-incremented counter past the epoch numbers, after
            # which wandb silently DROPS any log with a smaller explicit
            # step — epoch loss/stability/NLL curves would never appear.
            # The step travels as an ordinary field instead.
            payload = dict(metrics)
            if step is not None:
                payload["epoch"] = int(step)
            self._wandb_run.log(payload)

    def close(self) -> None:
        if self._file:
            self._file.close()
        if self._wandb_run is not None:
            self._wandb_run.finish()
