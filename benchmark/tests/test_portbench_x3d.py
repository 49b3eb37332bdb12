"""X3D-M's benchmark files (benchmark/networks/x3d_m.py, the channel-wise
conv bound in benchmark/yardstick/channelwise.py, the readers
dwconv_ms.train, se_swish_ms.train and dwconv_roofline.train) on the CPU:
the published counts, the description against the port's model key for
key, its plain forward against the tests' own reference, the FLOP count
against torch's flop counter, the tiny cell through its driver, and the
readers on fake spans and on a tree without them."""

import importlib.util
import json
import os

import pytest
import torch

from benchmark import harness, run
from benchmark.drivers import train
from benchmark.reference.models import Net
from benchmark.tests import tiny
from benchmark.yardstick import arch, channelwise, counts, spans, weights
from benchmark.yardstick.tracing import Trace

CELL = "train.x3d_m.bs64"
READERS = ("dwconv_ms.train", "se_swish_ms.train", "dwconv_roofline.train")
T0 = 1_800_000_000_000_000_000
SECOND = 1_000_000_000


def _tests_reference():
    """tests/x3d_reference.py, the port's tests' own plain X3D-M."""
    path = os.path.join(tiny.ROOT, "tests", "x3d_reference.py")
    spec = importlib.util.spec_from_file_location("x3d_reference", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _port(clip_len, size):
    from zeroshotvideoclassification_tpu_torch.config import Config
    from zeroshotvideoclassification_tpu_torch.models import get_network

    return get_network(Config(network="x3d_m", clip_len=clip_len,
                              size=size))


def test_published_counts():
    convs, epis, lins = arch.network("x3d_m", 16, 256)
    # 2 x 6.18 G multiply-adds a clip (the paper: 6.2 G at 16 x 256 x 256)
    assert sum(counts.conv_flops(c, 1) for c in convs) == 12359588352
    assert counts.forward_flops(convs, lins, 1) == 12359588352 + 9617408
    convs, epis, lins = arch.network("x3d_m", 16, 224)
    assert sum(counts.conv_flops(c, 1) for c in convs) == 9463299072
    assert len(epis) == 84 and sum(e.residual for e in epis) == 26
    assert sum(not e.relu for e in epis) == 26 + 4  # conv_b's, shortcuts'
    dw = [c for c in convs if channelwise.is_channelwise(c)]
    assert len(dw) == 27
    assert sum(counts.conv_flops(c, 1) for c in dw) == 1383277056
    assert len([c for c in convs if c.bias]) == 2 * 15  # the SE's convs


def test_channelwise_bytes_and_bound():
    convs, _, _ = arch.network("x3d_m", 16, 224)
    # 149 MB a clip forward in bf16 (x read, y written once), three
    # times that with both gradients
    assert channelwise.step_bytes(convs, 1) == 3 * 148646400
    assert channelwise.step_bound_seconds(convs, 64) == pytest.approx(
        64 * 3 * 148646400 / counts.HBM_BYTES_PER_S)
    stem = next(c for c in convs if channelwise.is_channelwise(c))
    assert channelwise.input_thw(stem) == stem.out_thw == (16, 112, 112)
    first = next(c for c in convs if c.name.endswith(
        "blocks.1.res_blocks.0.branch2.conv_b"))
    assert channelwise.input_thw(first) == (16, 112, 112)
    assert first.out_thw == (16, 56, 56)
    # the other networks have none
    convs, _, _ = arch.network("r2plus1d_18", 16, 112)
    assert channelwise.step_bytes(convs, 64) == 0


def test_description_matches_the_port_key_for_key():
    net = Net("x3d_m", 4, 32)
    params = weights.make(net, 3, "cpu")
    model = _port(4, 32)
    got = {k: tuple(p.shape) for k, p in model.named_parameters()}
    assert got == {k: tuple(v.shape) for k, v in params.items()}
    bn = {k.rsplit(".", 1)[0] for k, _ in model.named_buffers()}
    assert bn == {e.name for e in net.epilogues}
    train.load_params(model, params)  # raises where the keys differ


@pytest.mark.parametrize("mode", ["train", "eval"])
def test_embed_matches_the_tests_reference(mode):
    ref = _tests_reference()
    net = Net("x3d_m", **harness.load_network(tiny.ROOT, "x3d_m").TINY)
    params = weights.make(net, 5, "cpu")
    weights.calibrate(net, params, 5, 2, "cpu")
    # in float64: at the tiny size, with BN scales of 1, the train-mode
    # network amplifies float32 rounding (the two sum in other orders:
    # their first convs read other memory layouts) to 1e-5
    params = {k: v.double() for k, v in params.items()}
    x = torch.rand((2, 1, net.clip_len, net.size, net.size, 3),
                   generator=torch.Generator().manual_seed(6),
                   dtype=torch.float64) - 0.5
    with torch.no_grad():
        got = net.forward(params, x, train=mode == "train")
        want = ref.forward(params, x, train=mode == "train")
    torch.testing.assert_close(got, want, rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("mode", ["train", "eval"])
def test_forward_matches_the_port(mode):
    net = Net("x3d_m", 4, 32)
    params = weights.make(net, 3, "cpu")
    weights.calibrate(net, params, 3, 2, "cpu")
    model = _port(4, 32)
    train.load_params(model, params)
    model.train(mode == "train")
    x = torch.rand(2, 1, 4, 32, 32, 3,
                   generator=torch.Generator().manual_seed(8)) - 0.5
    with torch.no_grad():
        want = net.forward(params, x, train=mode == "train")
        got = model(x)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=2e-5)


@pytest.mark.parametrize("clip_len,size,clips", [(4, 32, 2), (8, 64, 1)])
def test_forward_flops_match_flop_counter(clip_len, size, clips):
    from torch.utils.flop_counter import FlopCounterMode

    model = _port(clip_len, size).eval()
    x = torch.zeros(clips, 1, clip_len, size, size, 3)
    with torch.no_grad(), FlopCounterMode(display=False) as fc:
        model(x)
    convs, _, linears = arch.network("x3d_m", clip_len, size)
    assert counts.forward_flops(convs, linears, clips) == \
        fc.get_total_flops()


def test_float32_steps_follow_the_port():
    ctx = tiny.context(CELL, compute_dtype="float32")
    out = train.run(ctx)
    prog, ref = out["readings"]["program"], out["readings"]["reference"]
    assert abs(prog["loss"][0] - ref["loss"][0]) <= 1e-5 * ref["loss"][0]
    assert out["numbers"]["grad_gap"] < 1e-3
    assert out["failed"] == 0 and out["attempted"] > 0


class Record:
    def __init__(self, steps=4):
        self.steps = steps
        self.root = tiny.ROOT
        self.cfg = harness.load_json(os.path.join(
            tiny.ROOT, "benchmark", "configs", "x3d_m-mlp.json"))
        self.local_clips = 64
        self.trace = Trace(device=[], spans=[], start_ns=T0,
                           end_ns=T0 + 10 * SECOND)


class FakeRegistry:
    def __init__(self, kept):
        self.kept = kept

    def instances(self, name):
        from zeroshotvideoclassification_tpu_torch.utils.profiler import (
            Instance,
        )

        return [Instance(*r) for r in self.kept.get(name, ())]


def _read(name, record):
    return harness.load_reader(tiny.ROOT, name)(record)


def _inside(k, ms):
    start = T0 + (k + 1) * SECOND // 20
    return (start, start + SECOND // 500, 1, ms)


def test_readers_read_their_spans_a_step(monkeypatch):
    kept = {"conv.depthwise": [_inside(k, 0.25) for k in range(27 * 4)],
            "conv.depthwise.backward": [_inside(k, 0.5)
                                        for k in range(27 * 4)],
            "se_swish": [_inside(k, 0.1) for k in range(26 * 4)],
            "se_swish.backward": [_inside(k, 0.2) for k in range(26 * 4)]
            + [(T0 - 10, T0 + 10, 1, 9.0)]}  # across the start: left out
    monkeypatch.setattr(spans, "registry", lambda: FakeRegistry(kept))
    rec = Record(steps=4)
    ms = 27 * 0.75
    assert _read("dwconv_ms.train", rec) == pytest.approx(ms)
    assert _read("se_swish_ms.train", rec) == pytest.approx(26 * 0.3)
    bound = channelwise.step_bound_seconds(
        arch.network("x3d_m", 16, 224)[0], 64)
    assert _read("dwconv_roofline.train", rec) == pytest.approx(
        100 * 1e3 * bound / ms)


@pytest.mark.parametrize("name", READERS)
def test_a_tree_without_the_spans_reads_nothing(name, monkeypatch):
    monkeypatch.setattr(spans, "registry", lambda: FakeRegistry({}))
    assert _read(name, Record()) is None
    monkeypatch.setattr(spans, "registry", lambda: None)
    assert _read(name, Record()) is None


def test_a_traced_tiny_run(capsys):
    from zeroshotvideoclassification_tpu_torch.utils import profiler

    profiler.reset()
    bench = harness.load_json(os.path.join(tiny.ROOT, "BENCHMARK.json"))
    ctx = tiny.context(CELL, trace=True, compute_dtype="float32")
    assert run.execute(ctx, bench) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["correct"] is True
    assert line["metrics"]["first_step_s.setup"]["value"] > 0
    # on the CPU the spans keep no CUDA events: the device readers are
    # silent
    assert not set(READERS) & set(line["metrics"])
    totals = profiler.registry().totals()
    assert totals["conv.depthwise"][0] % 27 == 0
    assert totals["se_swish"][0] % 26 == 0
