"""The program's own spans, as the per-layer readers see them.

The port keeps a process-wide registry of its spans
(zeroshotvideoclassification_tpu_torch/utils/profiler.py): per name the
count and host seconds of every instance, and, while torch.profiler
records, each instance's start and end on the profiler's clock with the
device ms between its CUDA events. The traced window is the same profiler
session, so a span belongs to the window where its start and end fall
inside `record.trace.start_ns` .. `end_ns`.

The readers run in the process that ran the program (the one-card cells);
in dp4 process 0 is a spawned process, and this one's registry is empty.
Everything here gives nothing, and raises nothing, where the program has
no registry (a tree without it) or kept no such span.
"""

from __future__ import annotations

from typing import List, Optional, Sequence


def registry():
    """The program's span registry, or None."""
    try:
        from zeroshotvideoclassification_tpu_torch.utils import profiler
    except ImportError:
        return None
    get = getattr(profiler, "registry", None)
    return get() if get is not None else None


def in_window(record, names: Sequence[str]) -> List:
    """The instances of the spans `names` inside the traced window."""
    reg, trace = registry(), record.trace
    if reg is None or trace is None:
        return []
    return [i for name in names for i in reg.instances(name)
            if trace.start_ns <= i.start_ns and i.end_ns <= trace.end_ns]


def device_ms_per_step(record, names: Sequence[str]) -> Optional[float]:
    """Device ms a step of the window's instances of `names` (their CUDA
    events), or None where none has any."""
    ms = [i.device_ms for i in in_window(record, names)
          if i.device_ms is not None]
    if not ms or not record.steps:
        return None
    return sum(ms) / record.steps


def host_ms_per_step(record, names: Sequence[str]) -> Optional[float]:
    """Host ms a step of the window's instances of `names`, or None."""
    inst = in_window(record, names)
    if not inst or not record.steps:
        return None
    return sum(i.end_ns - i.start_ns for i in inst) / 1e6 / record.steps


def first_seconds(name: str) -> Optional[float]:
    """Host seconds of the process's first instance of `name` (from the
    always-on totals), or None."""
    reg = registry()
    if reg is None:
        return None
    total = reg.totals().get(name)
    return total[2] if total else None
