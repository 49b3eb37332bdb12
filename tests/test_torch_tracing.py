"""The port's spans (utils/profiler.py): the always-on registry (counts,
totals, first instances, nesting, threads), what a span does and does not
do without a profiler (no range, no timestamped instance, no CUDA call),
under a CPU torch.profiler (a `zsv.<name>` range per span on the
profiler's clock), CUDA events (none inside a capture; a pool read
lazily), and the spans where the work happens: the train step's phases
and BN statistics, the feed, host decode and pack, the batcher's queue,
the engine and /stats, and --profile_dir's summary file.

The `cuda`-marked test compares the BN statistics' event brackets with the
kernels their ops launch (tools/check_bn_brackets.py) and skips without a
GPU; on the card, without the repository's conftest (which sets up JAX):

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_tracing.py
"""

import importlib.util
import json
import os
import sys
import threading
import time
import urllib.request

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from zeroshotvideoclassification_tpu_torch.utils import profiler

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def fresh_registry():
    profiler.reset()
    yield
    profiler.reset()


def _zsv_ranges(prof):
    """name -> sorted [(start_ns, end_ns)] of the trace's zsv.* host
    ranges."""
    out = {}
    for e in prof.profiler.kineto_results.events():
        if (e.name().startswith(profiler.PREFIX)
                and e.device_type() != torch.autograd.DeviceType.CUDA):
            out.setdefault(e.name()[len(profiler.PREFIX):], []).append(
                (e.start_ns(), e.start_ns() + e.duration_ns()))
    return {k: sorted(v) for k, v in out.items()}


# ------------------------------------------------------------ registry ----

@pytest.mark.parametrize("how", ["span", "add"])
def test_count_total_and_first_instance(how):
    waits = (0.02, 0.001, 0.005)
    took = []
    for w in waits:
        if how == "span":
            with profiler.span("t.work") as s:
                time.sleep(w)
            took.append(s.seconds)
        else:
            profiler.add("t.work", w)
            took.append(w)
    count, total, first = profiler.registry().totals()["t.work"]
    assert count == 3
    assert total == pytest.approx(sum(took))
    assert first == took[0] >= waits[0]
    s = profiler.summary()["t.work"]
    assert s["count"] == 3 and s["total_ms"] == pytest.approx(1e3 * total)
    assert s["first_s"] == first and "device_ms" not in s


@pytest.mark.parametrize("traced", [False, True])
def test_nested_spans(traced):
    def body():
        with profiler.span("t.outer"):
            time.sleep(0.002)
            for _ in range(2):
                with profiler.span("t.inner"):
                    time.sleep(0.002)

    if traced:
        with profile(activities=[ProfilerActivity.CPU]):
            body()
    else:
        body()
    t = profiler.registry().totals()
    assert t["t.outer"][0] == 1 and t["t.inner"][0] == 2
    assert t["t.outer"][1] > t["t.inner"][1] >= 0.004
    outer = profiler.registry().instances("t.outer")
    inner = profiler.registry().instances("t.inner")
    if not traced:
        assert outer == [] and inner == []
        return
    assert len(outer) == 1 and len(inner) == 2
    for i in inner:
        assert outer[0].start_ns <= i.start_ns < i.end_ns <= outer[0].end_ns
        assert i.thread == threading.get_ident() and i.device_ms is None


@pytest.mark.parametrize("threads", [2, 8])
def test_threads_at_once_lose_no_update(threads):
    n = 300
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        start = threading.Barrier(threads)

        def work():
            start.wait(timeout=30)
            for _ in range(n):
                with profiler.span("t.shared"):
                    pass
                profiler.add("t.added", 0.001)

        ts = [threading.Thread(target=work) for _ in range(threads)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in ts)
    finally:
        sys.setswitchinterval(old)
    totals = profiler.registry().totals()
    assert totals["t.shared"][0] == threads * n
    assert totals["t.added"][0] == threads * n
    assert totals["t.added"][1] == pytest.approx(threads * n * 0.001)


# ------------------------------------------------------- no profiler ----

def _forbid(*_, **__):
    raise AssertionError("called with no profiler recording")


def test_without_a_profiler_no_range_no_instance_no_cuda_call(monkeypatch):
    for name in ("is_initialized", "Event", "current_stream",
                 "current_device", "is_current_stream_capturing",
                 "synchronize"):
        monkeypatch.setattr(torch.cuda, name, _forbid)
    monkeypatch.setattr(profiler, "_Range", _forbid)
    x = torch.ones(3, requires_grad=True)
    with torch.enable_grad():
        with profiler.span("t.off"):
            y = x * 2
        profiler.backward_bracket("t.off.backward", (y,), y)
        profiler.add("t.off.wait", 0.5)
        y.sum().backward()
    assert y._backward_hooks is None  # no hook was registered
    for name in ("t.off", "t.off.wait"):
        assert profiler.registry().totals()[name][0] == 1
        assert profiler.registry().instances(name) == []
    assert "t.off.backward" not in profiler.registry().totals()


# ------------------------------------------------------ CPU profiler ----

@pytest.mark.parametrize("name", ["t.a", "train.forward"])
def test_a_range_per_span_on_the_profilers_clock(name):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiler.span("t.first"):  # the first range's set-up cost
            pass
        for _ in range(4):
            with profiler.span(name):
                torch.ones(256, 256).sum()
                time.sleep(0.001)
        profiler.add("t.waited", 0.003)
    ranges = _zsv_ranges(prof)
    mine = sorted(profiler.registry().instances(name))
    assert len(ranges[name]) == len(mine) == 4
    for inst, (a, b) in zip(mine, ranges[name]):
        assert abs(inst.start_ns - a) < 100_000
        assert abs(inst.end_ns - b) < 100_000
        assert inst.device_ms is None
    (waited,) = profiler.registry().instances("t.waited")
    assert waited.end_ns - waited.start_ns == 3_000_000
    assert ranges[name][-1][1] <= waited.end_ns
    assert "t.waited" not in ranges  # an interval is no range


# ----------------------------------------------------------- events ----

class _FakeEvent:
    """A timing event on a fake clock; `done` says whether query() sees it
    complete."""

    made = 0
    done = True

    def __init__(self, enable_timing=False):
        assert enable_timing
        type(self).made += 1
        self.at = None

    def record(self, stream=None):
        assert stream == "stream"  # the end on the start's stream
        self.at = time.perf_counter()

    def query(self):
        return type(self).done

    def elapsed_time(self, other):
        assert type(self).done
        return 1e3 * (other.at - self.at)


def _fake_cuda(monkeypatch, capturing: bool):
    _FakeEvent.made, _FakeEvent.done = 0, True
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: capturing)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda: "stream")
    monkeypatch.setattr(torch.cuda, "Event",
                        _forbid if capturing else _FakeEvent)


def test_a_capturing_stream_records_no_events(monkeypatch):
    _fake_cuda(monkeypatch, capturing=True)
    with profile(activities=[ProfilerActivity.CPU]):
        with profiler.span("t.captured"):
            pass
    (inst,) = profiler.registry().instances("t.captured")
    assert inst.device_ms is None
    assert "device_ms" not in profiler.summary()["t.captured"]


def test_events_come_from_a_pool_and_are_read_lazily(monkeypatch):
    _fake_cuda(monkeypatch, capturing=False)
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(3):
            with profiler.span("t.dev"):
                time.sleep(0.002)
            profiler.registry().instances("t.dev")  # read: pair back in pool
        _FakeEvent.done = False  # the device has not reached these yet
        for _ in range(2):
            with profiler.span("t.late"):
                pass
    # one pair served the three read spans and the first late one; the
    # second late span, with that pair in flight, took a new pair
    assert _FakeEvent.made == 4
    dev = [i.device_ms for i in profiler.registry().instances("t.dev")]
    assert len(dev) == 3 and all(ms >= 2.0 for ms in dev)
    assert [i.device_ms for i in profiler.registry().instances("t.late")] \
        == [None, None]
    _FakeEvent.done = True
    assert all(i.device_ms is not None
               for i in profiler.registry().instances("t.late"))
    assert profiler.summary()["t.dev"]["device_ms"] == pytest.approx(
        sum(dev))


# ------------------------------------------------- spans in the port ----

def _tiny_step(network):
    from zeroshotvideoclassification_tpu_torch.config import Config
    from zeroshotvideoclassification_tpu_torch.models import get_network
    from zeroshotvideoclassification_tpu_torch.train import (
        make_optimizer,
        make_train_step,
    )

    torch.manual_seed(0)
    cfg = Config(network=network, head="mlp", clip_len=4, size=32,
                 n_clips=1, compute_dtype="float32")
    model = get_network(cfg)
    step = make_train_step(model, make_optimizer(model.parameters(), 1e-3),
                           compute_dtype=torch.float32)
    g = torch.Generator().manual_seed(1)
    args = (torch.randn(2, 1, 4, 32, 32, 3, generator=g),
            torch.randn(2, 300, generator=g),
            torch.zeros(2, dtype=torch.int32),
            torch.ones(2), torch.randn(5, 300, generator=g))
    n_bn = sum(type(m).__name__ == "BatchNorm3d" for m in model.modules())
    return step, args, n_bn


PHASES = ("train.step", "train.forward", "train.backward", "train.grad_sum",
          "train.optimizer", "train.metrics")


@pytest.mark.parametrize("network,n_bn", [("r2plus1d_18", 37),
                                          ("mc3_18", 20)])
def test_train_step_phases_and_bn_statistics(network, n_bn):
    step, args, counted = _tiny_step(network)
    assert counted == n_bn
    steps = 2
    with torch.enable_grad():
        step(*args)  # untraced: the aggregates alone
        t = profiler.registry().totals()
        assert all(t[p][0] == 1 for p in PHASES)
        assert t["bn.stats"][0] == n_bn and "bn.stats.backward" not in t
        assert profiler.registry().instances("train.step") == []
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            for _ in range(steps):
                step(*args)
    reg = profiler.registry()
    for p in PHASES:
        assert len(reg.instances(p)) == steps, p
    assert len(reg.instances("bn.stats")) == steps * n_bn
    assert len(reg.instances("bn.stats.backward")) == steps * n_bn
    ranges = _zsv_ranges(prof)
    assert len(ranges["bn.stats"]) == steps * n_bn
    assert "bn.stats.backward" not in ranges  # a bracket, not a range
    for outer, inner in ((reg.instances("train.step")[0],
                          reg.instances("train.optimizer")[0]),
                         (reg.instances("train.backward")[0],
                          reg.instances("bn.stats.backward")[0])):
        assert outer.start_ns <= inner.start_ns <= inner.end_ns \
            <= outer.end_ns
    first = reg.totals()["train.step"][2]
    assert first > 0 and reg.totals()["train.step"][0] == steps + 1


def test_device_batch_on_the_cpu_opens_feed_and_no_pin():
    from zeroshotvideoclassification_tpu_torch.config import Config
    from zeroshotvideoclassification_tpu_torch.data.pipeline import (
        HostPipeline,
        device_batch,
    )
    from zeroshotvideoclassification_tpu_torch.data.synthetic import (
        build_synthetic_datasets,
    )

    cfg = Config(dataset="synthetic", class_total=6, train_samples=8, bs=4,
                 clip_len=4, n_clips=2, size=32, canvas_hw=(64, 86),
                 decode_workers=2, prefetch_depth=0)
    table = build_synthetic_datasets(cfg)["training"][0]
    batches = list(HostPipeline(table, cfg, 4, seed=0))
    t = profiler.registry().totals()
    assert t["host.decode"][0] == t["host.pack"][0] == len(batches) == 2
    out = device_batch(batches[0], 2, 4, torch.float32, "cpu")
    assert out["x"].shape == (4, 2, 4, 32, 32, 3)
    t = profiler.registry().totals()
    assert t["feed"][0] == 1 and "feed.pin" not in t


def test_batcher_records_each_requests_queue_wait():
    from zeroshotvideoclassification_tpu_torch.serve.batcher import (
        MicroBatcher,
    )

    b = MicroBatcher(lambda items: [i * 2 for i in items], max_batch=4,
                     max_wait_s=0.05)
    try:
        futs = [b.submit(i) for i in range(6)]
        assert [f.result(timeout=30) for f in futs] == [0, 2, 4, 6, 8, 10]
    finally:
        b.shutdown()
    count, total, first = profiler.registry().totals()["serve.queue_wait"]
    assert count == 6 and 0 <= first <= total < 6 * 30


def test_engine_stats_keep_their_keys_and_stats_has_spans(tmp_path):
    from zeroshotvideoclassification_tpu_torch.serve import (
        InferenceEngine,
        start_server,
    )
    from torch_helpers import synthetic_clip

    paths = []
    for i in range(3):
        p = tmp_path / f"clip{i}.npy"
        np.save(p, synthetic_clip(i, 12, 64, 86))
        paths.append(str(p))
    embed = np.random.default_rng(0).standard_normal((3, 300)).astype(
        np.float32)
    engine = InferenceEngine(["a", "b", "c"], embed, network="r2plus1d_18",
                             head="mlp", n_clips=1, clip_len=4, size=32,
                             max_batch=4, compute_dtype="float32",
                             device="cpu")
    server, service = start_server(engine, port=0, max_wait_s=0.02)
    try:
        engine.warmup()
        assert engine.span_stats() == {}  # the warm-up stays out
        assert engine.stats()["dispatches"] == 0
        url = f"http://127.0.0.1:{server.server_address[1]}"
        req = urllib.request.Request(
            url + "/classify", data=json.dumps({"videos": paths}).encode(),
            method="POST")
        with urllib.request.urlopen(req, timeout=120) as r:
            assert len(json.loads(r.read())["results"]) == 3
        with urllib.request.urlopen(url + "/stats", timeout=60) as r:
            stats = json.loads(r.read())
    finally:
        server.shutdown()
        server.server_close()
        service.close()
        engine.close()
    e = stats["engine"]
    assert e["dispatches"] >= 1 and e["device_seconds"] > 0
    spans = stats["spans"]
    assert spans["serve.dispatch"]["count"] == e["dispatches"]
    assert spans["serve.dispatch"]["total_ms"] == pytest.approx(
        1e3 * e["device_seconds"], abs=1.0)
    assert spans["serve.queue_wait"]["count"] == 3
    for name in ("serve.replica", "feed", "host.decode", "host.pack"):
        assert spans[name]["count"] >= 1 and spans[name]["total_ms"] > 0
    assert set(stats) == {"http_requests", "batcher", "engine", "spans"}


def test_profile_dir_writes_the_spans_summary(tmp_path):
    with profiler.device_trace(str(tmp_path / "traces")):
        with profiler.span("t.traced"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    names = sorted(os.listdir(tmp_path / "traces"))
    assert len(names) == 2
    assert names[0].startswith("spans_") and names[1].startswith("trace_")
    assert names[0][len("spans_"):] == names[1][len("trace_"):]
    with open(tmp_path / "traces" / names[0]) as f:
        spans = json.load(f)
    assert spans["t.traced"]["count"] == 1
    assert set(spans["t.traced"]) == {"count", "total_ms", "first_s"}


def test_the_trainers_profile_dir_holds_the_steps_spans(tmp_path):
    """cli.main's --profile_dir: the first epoch's trace, and beside it the
    spans' summary with the train step's phases, the BN statistics (20
    layers of R3D-18), the feed and host decode and pack."""
    from zeroshotvideoclassification_tpu_torch.cli import main
    from zeroshotvideoclassification_tpu_torch.config import (
        config_from_namespace,
    )
    from zeroshotvideoclassification_tpu_torch.data.datasets import (
        build_datasets,
    )
    from torch_helpers import remove_large_files

    prof = tmp_path / "prof"
    ns = main.build_arg_parser().parse_args([
        "--dataset", "synthetic", "--class_total", "4", "--train_samples",
        "16", "--bs", "8", "--n_epochs", "1", "--clip_len", "2", "--size",
        "32", "--network", "r3d_18", "--compute_dtype", "float32",
        "--seed", "1", "--no-progressbar", "--device", "cpu",
        "--save_path", str(tmp_path / "run"), "--profile_dir", str(prof)])
    cfg = config_from_namespace(ns).replace(
        eval_n_clips_both=2, eval_n_clips_others=2, nopretrained=True)
    try:
        with torch.enable_grad():
            main.Experiment(cfg, build_datasets(cfg, None),
                            device="cpu").run()
        (name,) = [n for n in os.listdir(prof) if n.startswith("spans_")]
        assert os.path.exists(prof / name.replace("spans_", "trace_"))
        with open(prof / name) as f:
            spans = json.load(f)
    finally:
        remove_large_files(tmp_path)
    steps = spans["train.step"]["count"]
    assert steps == 2  # 16 samples, 8 a step
    for p in PHASES[1:]:
        assert spans[p]["count"] == steps
    assert spans["bn.stats"]["count"] == 20 * steps
    assert spans["bn.stats.backward"]["count"] == 20 * steps
    assert spans["feed"]["count"] >= steps
    assert spans["host.decode"]["count"] >= steps
    assert spans["host.pack"]["count"] >= steps
    assert spans["train.step"]["first_s"] > 0


def test_bracket_tool_links_the_statistics_ops():
    """tools/check_bn_brackets.py on the CPU (a tiny r2plus1d_18 step)
    links each BN's forward ops in its range to their backward nodes: the
    two ops of ops/bn_stats.py, each with its own node, and nothing
    else."""
    spec = importlib.util.spec_from_file_location(
        "check_bn_brackets", os.path.join(ROOT, "tools",
                                          "check_bn_brackets.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    with torch.enable_grad():
        out = tool.measure(clips=2, steps=1, clip_len=4, size=32,
                           device="cpu")
    assert out["sums_ops"] == out["sums_nodes"] == 37
    assert out["forward_ops"] == out["backward_nodes"] == 2 * 37
    assert out["instances"] == {"bn.stats": 37, "bn.stats.backward": 37}
    assert out["sums_launches"] == out["sums_grad_launches"] == 0


# ------------------------------------------------------------- card ----

@pytest.mark.cuda
@pytest.mark.parametrize("clips", [64, 128])
def test_bn_brackets_agree_with_the_kernels_of_the_trace(clips):
    """The brackets' device ms a step within 10% of the kernels that
    bn_statistics' ops launch, forward and backward (linked by correlation
    id and sequence number), at the train cell's 64 clips and at twice
    that. (Where the host's launches under the profiler fall behind the
    device, the brackets take in the gaps between the kernels: 1.57x at 16
    clips on an H100 before the BN statistics became hand-written ops,
    1.6-2.0x at 64 clips since; 1.03x at 128.)"""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (run on the card)")
    spec = importlib.util.spec_from_file_location(
        "check_bn_brackets", os.path.join(ROOT, "tools",
                                          "check_bn_brackets.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    with torch.enable_grad():
        out = tool.measure(clips=clips, steps=2)
    assert out["forward_ops"] > 0 and out["backward_nodes"] > 0
    assert out["sums_ops"] == out["sums_nodes"] == 37
    assert out["sums_launches"] == out["sums_grad_launches"] == 37
    assert out["bracket_fwd_ms"] > 0 and out["bracket_bwd_ms"] > 0
    assert abs(out["ratio"] - 1) < 0.1, out
