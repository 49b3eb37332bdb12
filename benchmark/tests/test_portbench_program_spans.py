"""The readers of the program's own spans (benchmark/yardstick/spans.py and
benchmark/metrics/{bn_stats_ms,optimizer_ms,pin_ms}.train.py,
first_step_s.setup.py): each on a fake record and registry, nothing where
the registry is empty, where its instances lie outside the traced window
or where the program has no registry (a tree before it); and a traced run
of the tiny train cell on the CPU, in which first_step_s.setup reads above
0 and the readers of device events and pins read nothing."""

import json
import os

import pytest

from benchmark import harness, run
from benchmark.tests import tiny
from benchmark.yardstick import spans
from benchmark.yardstick.tracing import Trace

READERS = ("bn_stats_ms.train", "optimizer_ms.train", "pin_ms.train",
           "first_step_s.setup")
T0 = 1_800_000_000_000_000_000  # the window's start, ns on the clock
SECOND = 1_000_000_000


class Record:
    def __init__(self, steps=4):
        self.steps = steps
        self.trace = Trace(device=[], spans=[], start_ns=T0,
                           end_ns=T0 + 10 * SECOND)


class FakeRegistry:
    """Instances as the program's registry gives them: name -> [(start_ns,
    end_ns, thread, device_ms)]; totals name -> (count, s, first s)."""

    def __init__(self, kept=None, totals=None):
        self.kept, self._totals = kept or {}, totals or {}

    def instances(self, name):
        from zeroshotvideoclassification_tpu_torch.utils.profiler import (
            Instance,
        )

        return [Instance(*r) for r in self.kept.get(name, ())]

    def totals(self):
        return dict(self._totals)


def _read(name, record):
    return harness.load_reader(tiny.ROOT, name)(record)


def _inside(k, ms=None, length=0.002):
    start = T0 + (k + 1) * SECOND // 10
    return (start, start + int(length * SECOND), 1, ms)


@pytest.mark.parametrize("name", READERS)
def test_an_empty_registry_reads_nothing(name, monkeypatch):
    monkeypatch.setattr(spans, "registry", lambda: FakeRegistry())
    assert _read(name, Record()) is None


@pytest.mark.parametrize("name", READERS[:3])
def test_instances_outside_the_window_read_nothing(name, monkeypatch):
    outside = {n: [(T0 - SECOND, T0 - SECOND // 2, 1, 5.0),
                   (T0 - 1000, T0 + 1000, 1, 5.0),  # across the start
                   (T0 + 11 * SECOND, T0 + 12 * SECOND, 1, 5.0)]
               for n in ("bn.stats", "bn.stats.backward", "train.optimizer",
                         "feed.pin")}
    monkeypatch.setattr(spans, "registry", lambda: FakeRegistry(outside))
    assert _read(name, Record()) is None


def test_each_reader_reads_its_spans_a_step(monkeypatch):
    kept = {"bn.stats": [_inside(k, 1.5) for k in range(8)],
            "bn.stats.backward": [_inside(k, 2.0) for k in range(8)]
            + [_inside(9, None)],  # events not read: left out
            "train.optimizer": [_inside(k, 3.0) for k in range(4)]
            + [(T0 - 10, T0 + 10, 1, 99.0)],
            "feed.pin": [_inside(k, None, 0.004) for k in range(12)],
            "train.step": [_inside(k, 50.0) for k in range(4)]}
    totals = {"train.step": (7, 9.5, 6.25)}
    monkeypatch.setattr(spans, "registry",
                        lambda: FakeRegistry(kept, totals))
    rec = Record(steps=4)
    assert _read("bn_stats_ms.train", rec) == pytest.approx(
        (8 * 1.5 + 8 * 2.0) / 4)
    assert _read("optimizer_ms.train", rec) == pytest.approx(3.0)
    assert _read("pin_ms.train", rec) == pytest.approx(12 * 4.0 / 4)
    assert _read("first_step_s.setup", rec) == 6.25
    rec.steps = 0
    assert _read("optimizer_ms.train", rec) is None


@pytest.mark.parametrize("name", READERS)
def test_a_program_without_the_registry_reads_nothing(name, monkeypatch):
    from zeroshotvideoclassification_tpu_torch.utils import profiler

    monkeypatch.delattr(profiler, "registry")
    assert spans.registry() is None
    assert _read(name, Record()) is None


def test_a_traced_tiny_train_run_reads_the_first_step(capsys):
    from zeroshotvideoclassification_tpu_torch.utils import profiler

    profiler.reset()  # the first train.step of this process is the run's
    bench = harness.load_json(os.path.join(tiny.ROOT, "BENCHMARK.json"))
    ctx = tiny.context("train.r2plus1d_18.bs64", trace=True,
                       compute_dtype="float32")
    assert run.execute(ctx, bench) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["correct"] is True
    metrics = line["metrics"]
    assert metrics["first_step_s.setup"]["value"] > 0
    assert metrics["first_step_s.setup"]["unit"] == "s"
    # on the CPU: no CUDA events, no pinning
    assert not {"bn_stats_ms.train", "optimizer_ms.train",
                "pin_ms.train"} & set(metrics)
