"""The plain reference against the port at a tiny size on the CPU, and the
reference's independence: it imports nothing of the port or of JAX."""

import json
import subprocess
import sys

import numpy as np
import pytest
import torch

from benchmark.drivers import train
from benchmark.reference import serve as reference
from benchmark.reference.models import Net
from benchmark.reference.train import transform
from benchmark.tests import tiny
from benchmark.yardstick import traffic, videos, weights


def _port(network, clip_len, size, params):
    from zeroshotvideoclassification_tpu_torch.config import Config
    from zeroshotvideoclassification_tpu_torch.models import get_network

    model = get_network(Config(network=network, clip_len=clip_len,
                               size=size))
    train.load_params(model, params)
    return model


@pytest.mark.parametrize("network,clip_len,size", [("r2plus1d_18", 4, 32),
                                                   ("c3d", 16, 112),
                                                   ("r3d_18", 4, 32),
                                                   ("mc3_18", 4, 32)])
@pytest.mark.parametrize("mode", ["train", "eval"])
def test_forward_matches_the_port(network, clip_len, size, mode):
    net = Net(network, clip_len, size)
    params = weights.make(net, 3, "cpu")
    weights.calibrate(net, params, 3, 2, "cpu")
    model = _port(network, clip_len, size, params)
    model.train(mode == "train")
    x = torch.rand(2, 1, clip_len, size, size, 3) - 0.5
    with torch.no_grad():
        want = net.forward(params, x, train=mode == "train")
        got = model(x)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=2e-5)


@pytest.mark.parametrize("name", ["train.r2plus1d_18.bs64",
                                  "train.c3d.bs64"])
def test_float32_steps_follow_the_port(name):
    if name == "train.c3d.bs64":
        ctx = tiny.context(name, compute_dtype="float32")
        ctx.cell["traffic_params"].update(
            batch=1, canvas_hw=[128, 171], source_hw=[[120, 160]],
            short_side=128)
    else:
        ctx = tiny.context(name, compute_dtype="float32")
    out = train.run(ctx)
    prog, ref = out["readings"]["program"], out["readings"]["reference"]
    assert abs(prog["loss"][0] - ref["loss"][0]) <= 1e-5 * ref["loss"][0]
    assert out["numbers"]["grad_gap"] < 1e-3
    assert out["failed"] == 0 and out["attempted"] > 0


def test_transform_matches_the_port():
    from zeroshotvideoclassification_tpu_torch.data.pipeline import (
        device_batch,
    )

    cfg = tiny.context("train.r2plus1d_18.bs64").config
    tr = tiny.context("train.r2plus1d_18.bs64").cell["traffic_params"]
    hb = traffic.train_pool(cfg, tr, 11, "cpu")[0]
    got = device_batch(train.host_batch(hb), 1, cfg["clip_len"],
                       torch.float32, "cpu")["x"]
    want = transform(hb["canvas"], hb["y0"], hb["y1"], hb["wy"], hb["x0"],
                     hb["x1"], hb["wx"], 1, cfg["clip_len"], "cpu")
    torch.testing.assert_close(got, want, rtol=0, atol=2e-6)


def test_served_clips_match_the_port(tmp_path):
    from zeroshotvideoclassification_tpu_torch.config import Config
    from zeroshotvideoclassification_tpu_torch.data.pipeline import (
        device_batch,
        host_batch,
    )

    paths, frames, _ = videos.make(str(tmp_path), 2, (70, 90), (240, 320),
                                   90, 5, threads=2)
    config = Config(n_clips=4, clip_len=16, size=112)
    hb = host_batch(paths, config, 2, ["a"], np.zeros((1, 300), np.float32))
    got = device_batch(hb, 4, 16, torch.float32, "cpu")["x"]
    want = torch.stack([reference.clips(p, 4, 16, 112) for p in paths])
    # the port may decode with libjpeg, the reference with cv2: a level
    # or two of the 255 apart in a few pixels
    assert (got - want).abs().max() <= 3 / 510
    assert (got - want).abs().mean() <= 0.2 / 510


def test_reference_imports_nothing_of_the_port_or_jax():
    code = ("import sys, json; import benchmark.reference.train, "
            "benchmark.reference.serve, benchmark.reference.precision, "
            "benchmark.yardstick.checks; "
            "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=tiny.env(), cwd=tiny.ROOT,
                         check=True)
    loaded = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert not loaded & {"zeroshotvideoclassification_tpu_torch",
                         "zeroshotvideoclassification_tpu", "jax", "jaxlib",
                         "flax"}
