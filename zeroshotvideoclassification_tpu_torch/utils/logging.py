"""Observability: scalar logging (TB + CSV + JSONL), timers, throughput.

Parity with the reference's logging surface (reference/main.py:209-218,
266-276, 303-311): tensorboardX scalars when the package is available, the
same `{name}_accuracy.csv` / `{name}_accuracy_splits.csv` appenders, plus a
machine-readable metrics.jsonl and batch-vs-model time accounting (the
reference prints this split every epoch to diagnose input-bound training —
kept as first-class throughput counters: clips/sec is the north-star metric).
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional


class Timer:
    """Accumulating wall-clock timer (batch-time vs model-time accounting)."""

    def __init__(self):
        self.total = 0.0
        self._t0 = None

    def start(self):
        self._t0 = time.perf_counter()
        return self

    def stop(self) -> float:
        dt = time.perf_counter() - self._t0
        self.total += dt
        self._t0 = None
        return dt

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()


class MetricsLogger:
    def __init__(self, logdir: str, use_tensorboard: bool = True,
                 write: bool = True):
        """`write=False` makes every method a no-op — multi-host jobs compute
        metrics redundantly on every process but must write each artifact
        ONCE (shared filesystems would otherwise get duplicated CSV rows and
        racing TB/JSONL appends); the trainer passes process_index() == 0."""
        self.logdir = logdir
        self.write = write
        self._jsonl = None
        self._tb = None
        if not write:
            return
        os.makedirs(logdir, exist_ok=True)
        self._jsonl = open(os.path.join(logdir, "metrics.jsonl"), "a")
        if use_tensorboard:
            try:
                from tensorboardX import SummaryWriter

                self._tb = SummaryWriter(logdir=logdir)
            except Exception:
                self._tb = None

    def scalar(self, tag: str, value: float, step: int) -> None:
        if not self.write:
            return
        self._jsonl.write(json.dumps(
            {"tag": tag, "value": float(value), "step": int(step),
             "ts": time.time()}) + "\n")
        self._jsonl.flush()
        if self._tb is not None:
            self._tb.add_scalar(tag, value, step)

    def scalars(self, values: Dict[str, float], step: int,
                prefix: str = "") -> None:
        for k, v in values.items():
            if isinstance(v, (int, float)):
                self.scalar(prefix + k, v, step)

    def csv_append(self, filename: str, row: str) -> None:
        """Reference CSV appenders (main.py:275-276, 309-311)."""
        if not self.write:
            return
        with open(os.path.join(self.logdir, filename), "a") as f:
            f.write(row if row.endswith("\n") else row + "\n")

    def close(self) -> None:
        if self._jsonl is not None:
            self._jsonl.close()
        if self._tb is not None:
            self._tb.close()


def colored(text: str, color: str) -> str:
    codes = {"red": 31, "green": 32, "blue": 34, "yellow": 33}
    return f"\x1b[{codes.get(color, 0)}m{text}\x1b[0m"
