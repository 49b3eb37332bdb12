"""Profiling hooks: torch.profiler traces and step-time statistics.

Counterpart of zeroshotvideoclassification_tpu/utils/profiler.py, whose
jax.profiler trace becomes a torch.profiler one: host and, where there is
a GPU, device activity, written as a Chrome trace (viewable in Perfetto or
chrome://tracing) under the log directory.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import List, Optional


@contextlib.contextmanager
def device_trace(logdir: str):
    """Trace the body with torch.profiler (CPU activity, and CUDA's where
    a GPU is present) and write it to <logdir>/trace_<pid>_<time>.json
    when the body ends; a no-op if the profiler cannot start."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    try:
        prof.__enter__()
        started = True
    except RuntimeError:  # another profiler is running
        started = False
    try:
        yield
    finally:
        if started:
            if torch.cuda.is_available():
                torch.cuda.synchronize()
            prof.__exit__(None, None, None)
            os.makedirs(logdir, exist_ok=True)
            prof.export_chrome_trace(os.path.join(
                logdir, f"trace_{os.getpid()}_{int(time.time())}.json"))


class StepStats:
    """Steady-state step timing: mean/p50/p90 after a warmup prefix."""

    def __init__(self, warmup: int = 3):
        self.warmup = warmup
        self.times: List[float] = []
        self._t0: Optional[float] = None

    def tick(self) -> None:
        now = time.perf_counter()
        if self._t0 is not None:
            self.times.append(now - self._t0)
        self._t0 = now

    def summary(self, items_per_step: float = 1.0) -> dict:
        ts = self.times[self.warmup:] or self.times
        if not ts:
            return {}
        import numpy as np

        arr = np.asarray(ts)
        return {
            "mean_s": float(arr.mean()),
            "p50_s": float(np.percentile(arr, 50)),
            "p90_s": float(np.percentile(arr, 90)),
            "items_per_sec": items_per_step / float(arr.mean()),
            "n": len(arr),
        }
