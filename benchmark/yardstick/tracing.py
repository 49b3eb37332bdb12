"""The benchmark's own spans and the reading of a torch.profiler trace.

`Recorder.span(name)` times a call into a layer with the host's clock (in
every run) and, in a traced run, also marks it in the trace as
`bench.<name>`, so that an idle gap of the device can be put down to what
the host was doing. `Recorder.window()` brackets the measured window; with
tracing on it runs torch.profiler over it (host and device activity) and
afterwards holds a `Trace`: the device's operations and the host's
`bench.*` spans, in nanoseconds on the profiler's clock.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import threading
import time
from typing import Dict, List, Optional, Tuple

from benchmark.yardstick.counts import kind

WINDOW = "bench.window"


@dataclasses.dataclass
class Trace:
    device: List[Tuple[int, int, str]]   # (start_ns, end_ns, name)
    spans: List[Tuple[int, int, str]]    # host bench.* spans
    start_ns: int
    end_ns: int

    @property
    def window_s(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9

    def busy_intervals(self) -> List[Tuple[int, int]]:
        """The union of the device's operations inside the window."""
        iv = sorted((max(a, self.start_ns), min(b, self.end_ns))
                    for a, b, _ in self.device)
        out: List[List[int]] = []
        for a, b in iv:
            if b <= a:
                continue
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return [(a, b) for a, b in out]

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) / 1e9

    def gaps(self) -> List[Tuple[int, int]]:
        """The window's stretches in which no operation ran on the
        device."""
        out, t = [], self.start_ns
        for a, b in self.busy_intervals():
            if a > t:
                out.append((t, a))
            t = max(t, b)
        if t < self.end_ns:
            out.append((t, self.end_ns))
        return out

    def host_at(self, times: List[int]) -> List[str]:
        """For each of the increasing `times`, the innermost bench.* span
        around it (its name without "bench."), else "other"."""
        spans = sorted(s for s in self.spans if s[2] != WINDOW)
        out, active, i = [], [], 0
        for t in times:
            while i < len(spans) and spans[i][0] <= t:
                active.append(spans[i])
                i += 1
            active = [s for s in active if s[1] >= t]
            best = min(active, key=lambda s: s[1] - s[0], default=None)
            out.append(best[2][len("bench."):] if best else "other")
        return out

    def device_seconds(self, match) -> float:
        """Seconds of the device operations whose name `match` accepts."""
        return sum(b - a for a, b, name in self.device if match(name)) / 1e9

    def breakdown(self, top: int = 10) -> dict:
        by_kind: Dict[str, float] = collections.Counter()
        for a, b, name in self.device:
            by_kind[kind(name)] += (b - a) / 1e9
        idle: Dict[str, float] = collections.Counter()
        gaps = self.gaps()
        for (a, b), label in zip(gaps, self.host_at(
                [(a + b) // 2 for a, b in gaps])):
            idle[label] += (b - a) / 1e9
        return {"device_ops": [[k, v] for k, v in sorted(
                    by_kind.items(), key=lambda kv: -kv[1])[:top]],
                "idle_gaps": [[k, v] for k, v in sorted(
                    idle.items(), key=lambda kv: -kv[1])[:top]]}


def _read_profile(prof) -> Trace:
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    device, spans = [], []
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if e.device_type() == cuda and not (e.is_user_annotation()
                                            or name.startswith("bench.")):
            start = e.start_ns()
            device.append((start, start + e.duration_ns(), name))
        elif name.startswith("bench.") and e.device_type() != cuda:
            start = e.start_ns()
            spans.append((start, start + e.duration_ns(), name))
    window = [s for s in spans if s[2] == WINDOW]
    if not window:
        raise RuntimeError("the trace holds no bench.window span")
    return Trace(device, spans, window[0][0], window[0][1])


def _all_threads() -> dict:
    """The profiler's option to record the host spans of every thread (the
    serving engine's and batcher's too), where this PyTorch has it."""
    try:
        from torch._C._profiler import _ExperimentalConfig

        return {"experimental_config": _ExperimentalConfig(
            profile_all_threads=True)}
    except (ImportError, TypeError):
        return {}


class Recorder:
    """Host spans of the benchmark's own calls, and the trace of a traced
    window."""

    def __init__(self, trace: bool):
        self.tracing = bool(trace)
        self.seconds: Dict[str, List[float]] = collections.defaultdict(list)
        self._lock = threading.Lock()
        self.trace: Optional[Trace] = None
        self.window_s: Optional[float] = None

    @contextlib.contextmanager
    def span(self, name: str):
        t0 = time.perf_counter()
        if self.tracing:
            from torch.profiler import record_function

            with record_function("bench." + name):
                yield
        else:
            yield
        dt = time.perf_counter() - t0
        with self._lock:
            self.seconds[name].append(dt)

    @contextlib.contextmanager
    def window(self, sync, before=None):
        """Time the body (ended by `sync()`, which waits for the device);
        trace it when tracing is on. `before()` runs first, after the
        profiler has started (which takes seconds) and outside the
        window."""
        prof = None
        if self.tracing:
            from torch.profiler import ProfilerActivity, profile, \
                record_function

            prof = profile(activities=[ProfilerActivity.CPU,
                                       ProfilerActivity.CUDA],
                           **_all_threads())
            prof.__enter__()
        if before is not None:
            before()
        if prof is not None:
            mark = record_function(WINDOW)
            mark.__enter__()
        t0 = time.perf_counter()
        try:
            yield
            sync()
        finally:
            self.window_s = time.perf_counter() - t0
            if prof is not None:
                mark.__exit__(None, None, None)
                prof.__exit__(None, None, None)
        if prof is not None:
            self.trace = _read_profile(prof)
