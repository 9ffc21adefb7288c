"""Structured metric logging: stdout + JSON-lines + optional TensorBoard
(a copy of the JAX package's ``utils/logging.py``).

Replaces the reference's tensorboardX SummaryWriter usage
(cifar100_train_eval.py:33, :156, :190-191, :211) with a dependency-free
JSONL writer using the same metric names (``cls_loss``, ``learning rate``,
``Precision@1``, ``Precision@5``) so runs stay comparable; if tensorboardX
happens to be installed it is used as well.
"""

from __future__ import annotations

import json
import pathlib
import time
from typing import Optional


class MetricLogger:
    def __init__(self, log_dir: str, run_name: str = "run"):
        self.dir = pathlib.Path(log_dir)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.path = self.dir / f"{run_name}.jsonl"
        self._file = open(self.path, "a")
        self._tb = None
        try:
            from tensorboardX import SummaryWriter  # optional

            self._tb = SummaryWriter(str(self.dir))
        except ImportError:
            pass

    def scalar(self, name: str, value: float, step: int) -> None:
        rec = {"t": time.time(), "name": name, "value": float(value),
               "step": int(step)}
        self._file.write(json.dumps(rec) + "\n")
        self._file.flush()
        if self._tb is not None:
            self._tb.add_scalar(name, value, step)

    def close(self) -> None:
        self._file.close()
        if self._tb is not None:
            self._tb.close()
