"""The port's spans and counters, and torch.profiler traces.

Counterpart of zeroshotvideoclassification_tpu/utils/profiler.py, whose
jax.profiler trace becomes a torch.profiler one (`device_trace`).

`span(name)` brackets a piece of work where it happens (the train step and
its phases, the BN statistics, the feed, the serving path). It always adds
to one process-wide registry, per name: the count, the total host seconds
and the first instance's host seconds (time.perf_counter). While a
torch.profiler session records, and only then, it also

  * opens a profiler range named `zsv.<name>` (torch's
    _RecordFunctionFast where it has one, else record_function), so the
    span shows in the trace;
  * keeps the instance's start and end in the profiler's own clock (Unix
    nanoseconds, time.time_ns()) and its thread, so that it can be placed
    against the trace's device operations and idle gaps;
  * on a CUDA device, outside a graph capture, records a pair of timing
    CUDA events on the current stream (from a pool). Their elapsed time is
    read lazily, when the registry is read after the caller's own
    synchronise; a span never synchronises.

With no profiler recording a span costs two clock reads, one bool read and
the registry's add under its lock: no device call, no allocation on the
device, no string formatting. `add(name, seconds)` records an interval that
starts on one thread and ends on another (a request's wait in the
batcher's queue); `backward_bracket` times a stretch of autograd's backward
between hooks (the BN statistics' gradient).
"""

from __future__ import annotations

import collections
import contextlib
import json
import os
import threading
import time
from typing import Dict, List, NamedTuple, Optional

import torch
import torch.autograd.profiler as _autograd_profiler

PREFIX = "zsv."
# a range without the dispatcher's cost: its timestamps sit within a few
# microseconds of the span's own (record_function's, 60 us and more)
_Range = getattr(torch._C._profiler, "_RecordFunctionFast",
                 torch.autograd.profiler.record_function)
# pending event pairs past which a traced span checks which have completed
# (without waiting), so that a long traced run holds a bounded set
_RESOLVE_AT = 1024


class Instance(NamedTuple):
    """One span kept while a profiler recorded: start and end in the
    profiler's clock (ns), the thread, and the device ms between its CUDA
    events (None without events, or before they completed)."""

    start_ns: int
    end_ns: int
    thread: int
    device_ms: Optional[float]


class Registry:
    """Per name: [count, host seconds, first instance's host seconds]; the
    instances kept while a profiler recorded; their CUDA events, pooled per
    device. Thread-safe: the trainer, autograd's backward thread, the
    engine's device threads and the batcher all record into it."""

    def __init__(self):
        self._lock = threading.Lock()
        self._totals: Dict[str, List[float]] = {}
        self._kept: Dict[str, List[list]] = {}
        self._pending: collections.deque = collections.deque()
        self._free: Dict[int, list] = collections.defaultdict(list)

    def add(self, name: str, seconds: float) -> None:
        with self._lock:
            t = self._totals.get(name)
            if t is None:
                self._totals[name] = [1, seconds, seconds]
            else:
                t[0] += 1
                t[1] += seconds

    def keep(self, name: str, start_ns: int, end_ns: int,
             events=None) -> None:
        """Keep a timestamped instance (and its CUDA events from
        start_event, the end recorded, read later)."""
        rec = [start_ns, end_ns, threading.get_ident(), None]
        with self._lock:
            self._kept.setdefault(name, []).append(rec)
            if events is not None:
                self._pending.append((rec, *events[:3]))
                if len(self._pending) >= _RESOLVE_AT:
                    self._resolve(stop_at_first=True)

    def start_event(self):
        """(device, start event, end event, stream): a pair from the pool,
        the start recorded on the current stream, which the end is to be
        recorded on; None outside CUDA or inside a graph capture."""
        if (not torch.cuda.is_initialized()
                or torch.cuda.is_current_stream_capturing()):
            return None
        device = torch.cuda.current_device()
        with self._lock:
            free = self._free[device]
            pair = free.pop() if free else None
        if pair is None:
            pair = (torch.cuda.Event(enable_timing=True),
                    torch.cuda.Event(enable_timing=True))
        stream = torch.cuda.current_stream()
        pair[0].record(stream)
        return device, pair[0], pair[1], stream

    def _resolve(self, stop_at_first: bool = False) -> None:
        """Read the elapsed time of every completed pending pair (a query,
        no wait) and return its events to the pool; with `stop_at_first`,
        of the oldest ones up to the first not completed. Under the
        lock."""
        if stop_at_first:
            while self._pending and self._read(*self._pending[0]):
                self._pending.popleft()
            return
        self._pending = collections.deque(
            item for item in self._pending if not self._read(*item))

    def _read(self, rec, device, start, end) -> bool:
        if not end.query():
            return False
        rec[3] = start.elapsed_time(end)
        self._free[device].append((start, end))
        return True

    def totals(self) -> Dict[str, tuple]:
        """name -> (count, host seconds, first instance's host seconds)."""
        with self._lock:
            return {k: tuple(v) for k, v in self._totals.items()}

    def instances(self, name: str) -> List[Instance]:
        """The instances of `name` kept while a profiler recorded."""
        with self._lock:
            self._resolve()
            return [Instance(*r) for r in self._kept.get(name, ())]

    def summary(self) -> Dict[str, dict]:
        """name -> {count, total_ms, first_s} (every instance) and
        device_ms (the sum over the kept instances whose events have been
        read; only where there are such)."""
        with self._lock:
            self._resolve()
            out = {}
            for name, (count, total, first) in self._totals.items():
                out[name] = {"count": int(count), "total_ms": 1e3 * total,
                             "first_s": first}
                ms = [r[3] for r in self._kept.get(name, ())
                      if r[3] is not None]
                if ms:
                    out[name]["device_ms"] = sum(ms)
            return out

    def reset(self) -> None:
        with self._lock:
            self._totals.clear()
            self._kept.clear()
            self._pending.clear()


_REGISTRY = Registry()


def registry() -> Registry:
    """The process's registry."""
    return _REGISTRY


def reset() -> None:
    _REGISTRY.reset()


def summary() -> Dict[str, dict]:
    return _REGISTRY.summary()


def add(name: str, seconds: float) -> None:
    """Record an interval of `seconds` that ended now (begun on another
    thread, perhaps); kept with its timestamps while a profiler records."""
    _REGISTRY.add(name, seconds)
    if _autograd_profiler._is_profiler_enabled:
        end = time.time_ns()
        _REGISTRY.keep(name, end - int(seconds * 1e9), end)


class span:
    """`with span(name) as s:` times the body (module docstring);
    `s.seconds` is its host time once it ends."""

    __slots__ = ("name", "t0", "traced", "seconds")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.traced = None
        if _autograd_profiler._is_profiler_enabled:
            rf = _Range(PREFIX + self.name)
            rf.__enter__()
            self.traced = (rf, time.time_ns(), _REGISTRY.start_event())
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.seconds = dt = time.perf_counter() - self.t0
        if self.traced is not None:
            rf, start_ns, events = self.traced
            if events is not None:
                events[2].record(events[3])
            _REGISTRY.keep(self.name, start_ns, time.time_ns(), events)
            rf.__exit__(None, None, None)
        _REGISTRY.add(self.name, dt)
        return False


def backward_bracket(name: str, starts, end: torch.Tensor) -> None:
    """While a profiler records: time autograd's backward from the first
    gradient to reach any tensor of `starts` (its node begins) to the
    gradient of `end` being complete, as one instance of `name` (host
    seconds, timestamps and, on CUDA, a pair of events on the backward's
    stream). Nothing without a profiler, or where `end` needs no
    gradient."""
    if not _autograd_profiler._is_profiler_enabled or not end.requires_grad:
        return
    opened = []

    def first(grad):
        if not opened:
            opened.append((time.perf_counter(), time.time_ns(),
                           _REGISTRY.start_event()))

    def last(grad):
        if opened:
            t0, start_ns, events = opened.pop()
            if events is not None:
                events[2].record(events[3])
            _REGISTRY.keep(name, start_ns, time.time_ns(), events)
            _REGISTRY.add(name, time.perf_counter() - t0)

    for t in starts:
        if t.requires_grad:
            t.register_hook(first)
    end.register_hook(last)


@contextlib.contextmanager
def device_trace(logdir: str):
    """Trace the body with torch.profiler (CPU activity, and CUDA's where
    a GPU is present) and write it to <logdir>/trace_<pid>_<time>.json
    when the body ends, with the registry's summary() beside it as
    spans_<pid>_<time>.json (counts and host totals since the process
    started; device ms of the spans the trace saw); a no-op if the
    profiler cannot start."""
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
            stamp = f"{os.getpid()}_{int(time.time())}"
            prof.export_chrome_trace(os.path.join(
                logdir, f"trace_{stamp}.json"))
            with open(os.path.join(logdir, f"spans_{stamp}.json"), "w") as f:
                json.dump(summary(), f, indent=1, sort_keys=True)
