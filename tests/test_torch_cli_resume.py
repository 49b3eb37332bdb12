"""The port's trainer keeps what it trains, on the CPU, at the smallest
configuration of tests/test_cli.py (4 classes, 16 samples, --bs 8,
--clip_len 2, --size 32, r3d_18, float32): --checkpoint_every writes
last.npz, --resume auto goes on in the same directory (or starts fresh
where there is nothing to resume), a run interrupted after epoch 0 and
resumed logs the uninterrupted run's metrics bit for bit, and a
checkpoint written by the JAX package evaluates in the port's --evaluate
to the JAX package's accuracy."""

import glob
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from zeroshotvideoclassification_tpu.cli.main import Experiment as JaxExp
from zeroshotvideoclassification_tpu.config import config_from_args
from zeroshotvideoclassification_tpu.data.datasets import (
    build_datasets as jax_build_datasets,
)
from zeroshotvideoclassification_tpu.models import get_network as jax_network
from zeroshotvideoclassification_tpu.train.checkpoint import (
    save_checkpoint as jax_save_checkpoint,
)
from zeroshotvideoclassification_tpu.train.optimizer import (
    make_optimizer as jax_make_optimizer,
)
from zeroshotvideoclassification_tpu.train.step import (
    TrainState as JaxTrainState,
)
from zeroshotvideoclassification_tpu_torch.cli import main as port_main
from zeroshotvideoclassification_tpu_torch.config import config_from_namespace
from zeroshotvideoclassification_tpu_torch.data.datasets import build_datasets
from zeroshotvideoclassification_tpu_torch.train import read_meta

from torch_helpers import randomize_bn, remove_large_files

ARGS = [
    "--dataset", "synthetic", "--class_total", "4", "--train_samples", "16",
    "--bs", "8", "--n_epochs", "1", "--clip_len", "2", "--size", "32",
    "--network", "r3d_18", "--compute_dtype", "float32", "--seed", "1",
    "--no-progressbar",
]
# tests/test_cli.py's settings: 2 clips a test video, no pretrained asset
OVERRIDES = {"eval_n_clips_both": 2, "eval_n_clips_others": 2,
             "nopretrained": True}


@pytest.fixture(autouse=True)
def drop_checkpoints(tmp_path):
    """Delete the test's checkpoint files (and any other large file) when it
    ends: full-width models make files of 140-400 MB each
    (torch_helpers.remove_large_files)."""
    yield
    remove_large_files(tmp_path)


def _run(save_path, extra=(), **overrides):
    ns = port_main.build_arg_parser().parse_args(
        ARGS + ["--save_path", str(save_path), "--device", "cpu", *extra])
    cfg = config_from_namespace(ns).replace(**OVERRIDES, **overrides)
    exp = port_main.Experiment(cfg, build_datasets(cfg, None), device="cpu")
    return exp.run()


def _metrics(root):
    out = {}
    for p in glob.glob(str(root / "**" / "metrics.jsonl"), recursive=True):
        with open(p) as f:
            for line in f:
                rec = json.loads(line)
                out[(rec["tag"], rec["step"])] = rec["value"]
    return out


def test_periodic_checkpoint_and_auto_resume(tmp_path, capsys):
    """--checkpoint_every 1 writes <run>/last.npz (and the improving epoch
    <run>/checkpoint.npz); --resume auto takes the newest and REUSES the
    run's directory; a fresh directory with --resume auto is a fresh run."""
    _run(tmp_path, ["--checkpoint_every", "1"])
    lasts = glob.glob(str(tmp_path / "**" / "last.npz"), recursive=True)
    assert len(lasts) == 1
    run_dir = os.path.dirname(lasts[0])
    assert read_meta(lasts[0])["epoch"] == 0
    n_dirs = len(os.listdir(os.path.dirname(run_dir)))

    summary = _run(tmp_path, ["--resume", "auto", "--n_epochs", "2",
                              "--checkpoint_every", "1"])
    assert "best_accuracy" in summary
    assert f"RESUMED: {lasts[0]} at epoch 1" in capsys.readouterr().out
    assert len(os.listdir(os.path.dirname(run_dir))) == n_dirs
    assert read_meta(lasts[0])["epoch"] == 1

    summary = _run(tmp_path / "fresh", ["--resume", "auto"])
    assert "no checkpoint found, fresh run" in capsys.readouterr().out
    assert np.isfinite(summary["loss"])


def test_resume_is_bit_deterministic(tmp_path):
    """A run interrupted after epoch 0 and resumed with --resume auto logs
    exactly what the uninterrupted run logs, epoch 1 included (train loss
    and accuracy at each step, test accuracies), and ends with the same
    summary: the checkpoint holds the whole state, and the host pipeline
    and the step's generator are seeded per (seed, epoch)."""
    a_dir, b_dir = tmp_path / "uninterrupted", tmp_path / "interrupted"
    every = ["--checkpoint_every", "1"]
    a_sum = _run(a_dir, ["--n_epochs", "2", *every], log_every=1)
    _run(b_dir, ["--n_epochs", "1", *every], log_every=1)
    b_sum = _run(b_dir, ["--resume", "auto", "--n_epochs", "2", *every],
                 log_every=1)
    a, b = _metrics(a_dir), _metrics(b_dir)
    assert a == b
    assert ("synthetic_test/Accuracy", 1) in a
    steps = sorted(s for t, s in a if t == "Train/Loss")
    assert steps and steps[-1] >= 3  # epoch 1's steps are logged
    for k in ("loss", "train_accuracy", "synthetic_test_accuracy",
              "best_accuracy"):
        assert a_sum[k] == b_sum[k], k


def test_evaluate_a_jax_checkpoint(tmp_path):
    """A checkpoint.npz that the JAX package wrote (seeded r3d_18 weights
    with random BN statistics) given to --evaluate --weights: the port's
    accuracies are the JAX package's --evaluate accuracies."""
    model = jax_network(config_from_args(ARGS))
    params, state = jax.jit(model.init)(jax.random.PRNGKey(3))
    params = jax.tree.map(np.array, params)
    state = jax.tree.map(np.array, state)
    randomize_bn(params, state, np.random.default_rng(3))
    ts = JaxTrainState(params, state, jax_make_optimizer(1e-3).init(params),
                       jnp.asarray(7, jnp.int32))
    path = str(tmp_path / "jax" / "checkpoint.npz")
    jax_save_checkpoint(path, ts, epoch=3, accuracy=50.0)

    extra = ["--evaluate", "--weights", path]
    jcfg = config_from_args(ARGS + ["--save_path", str(tmp_path / "j"),
                                    *extra]).replace(**OVERRIDES)
    want = JaxExp(jcfg, jax_build_datasets(jcfg, None)).run()
    got = _run(tmp_path / "p", extra)
    assert set(got) == set(want) == {"synthetic_test_accuracy",
                                     "best_accuracy"}
    assert got == want


def test_resume_auto_takes_the_newest_stored_epoch(tmp_path):
    """--resume auto ranks checkpoints by the epoch they store, over the
    run's directory and its _N siblings; last.npz wins a tie with
    checkpoint.npz; a file that does not read as a checkpoint (a write cut
    short) is passed over."""
    from zeroshotvideoclassification_tpu_torch.train import save_checkpoint

    base = str(tmp_path / "run")
    payload = {"__step__": np.zeros((), np.int32)}
    save_checkpoint(os.path.join(base, "checkpoint.npz"), payload, 3, 40.0)
    save_checkpoint(os.path.join(base, "last.npz"), payload, 2, 40.0)
    save_checkpoint(os.path.join(base + "_1", "checkpoint.npz"), payload, 5,
                    50.0)
    save_checkpoint(os.path.join(base + "_1", "last.npz"), payload, 5, 50.0)
    os.makedirs(base + "_2")
    with open(os.path.join(base + "_2", "last.npz"), "wb") as f:
        f.write(b"PK\x03\x04 cut short")
    assert port_main._find_latest_checkpoint(base) == os.path.join(
        base + "_1", "last.npz")
    assert port_main._find_latest_checkpoint(str(tmp_path / "none")) is None
