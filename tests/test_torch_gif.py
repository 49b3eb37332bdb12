"""--save_samples and the port's copy of utils/gif.py: inverse_transform and
batch2gif against the JAX package's (file names and frames), the trainer's
GIF of the first clip of each epoch on the CPU (the transform's float32
output of its first host batch), the JAX package's warning and an
unchanged run with imageio blocked, and on 2 gloo processes a GIF from
process 0 only. The trainer runs at tests/test_torch_parallel.py's size:
r3d_18, 2 frames of 32x32, float32."""

import glob
import json
import os
import sys

import numpy as np
import pytest
import torch

from zeroshotvideoclassification_tpu.utils import gif as jax_gif
from zeroshotvideoclassification_tpu_torch.cli import main as port_main
from zeroshotvideoclassification_tpu_torch.data.pipeline import (
    HostPipeline,
    device_batch,
)
from zeroshotvideoclassification_tpu_torch.utils import gif

from test_torch_parallel import SMALL, launch


@pytest.fixture
def imageio():
    return pytest.importorskip("imageio")


@pytest.fixture(autouse=True)
def grad_enabled():
    """Another test module switches autograd off for its whole process when
    it is imported; the trainer differentiates."""
    with torch.enable_grad():
        yield


def argv(tmp_path, *flags):
    return SMALL + ["--class_total", "4", "--train_samples", "8", "--bs",
                    "4", "--n_epochs", "2", "--device", "cpu", "--save_path",
                    str(tmp_path / "runs"), *flags]


@pytest.mark.parametrize("mode", ["active", "meanstd"])
def test_inverse_transform_matches_jax(mode):
    rng = np.random.default_rng(3)
    frames = rng.uniform(-0.6, 0.1, (4, 9, 7, 3)).astype(np.float32)
    if mode == "meanstd":
        frames = rng.normal(0, 1.5, (4, 9, 7, 3)).astype(np.float32)
    got = gif.inverse_transform(frames, mode)
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, jax_gif.inverse_transform(frames,
                                                                 mode))
    with pytest.raises(ValueError):
        gif.inverse_transform(frames, "nope")


@pytest.mark.parametrize("label,classes", [(1, ["a", "b/c"]), (0, None)])
def test_batch2gif_matches_jax(tmp_path, imageio, label, classes):
    """The same file name ('/' in a class name becomes '_'; no class: the
    bare prefix) and the same frames read back."""
    frames = np.random.default_rng(4).uniform(
        -0.5, 0, (5, 16, 12, 3)).astype(np.float32)
    (tmp_path / "port").mkdir()
    (tmp_path / "jax").mkdir()
    got = gif.batch2gif(frames, label, str(tmp_path / "port" / "ep0_"),
                        classes=classes)
    want = jax_gif.batch2gif(frames, label, str(tmp_path / "jax" / "ep0_"),
                             classes=classes)
    assert os.path.basename(got) == os.path.basename(want)
    assert os.path.basename(got) == ("ep0_b_c.gif" if classes
                                     else "ep0_.gif")
    a, b = imageio.mimread(got), imageio.mimread(want)
    assert len(a) == len(b) == 5
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


def _samples(root):
    return sorted(glob.glob(os.path.join(root, "**", "samples", "*.gif"),
                            recursive=True))


def test_trainer_writes_the_first_clip_of_each_epoch(tmp_path, imageio):
    """Two epochs: samples/samples_train_epoch{0,1}_<class>.gif, each the
    JAX package's GIF of the first clip of that epoch's first host batch
    through the transform (float32), inverted as the video chain."""
    args = argv(tmp_path, "--save_samples")
    summary = port_main.main(args)
    assert np.isfinite(summary["loss"])
    files = _samples(tmp_path)
    cfg = port_main.config_from_namespace(
        port_main.build_arg_parser().parse_args(args))
    table = port_main.build_datasets(cfg, None)["training"][0]
    assert len(files) == 2
    for epoch, path in enumerate(files):
        host = next(iter(HostPipeline(table, cfg, cfg.bs,
                                      seed=cfg.seed + epoch)))
        name = table.classes[int(host.label[0])].replace("/", "_")
        assert os.path.basename(path) == (
            f"samples_train_epoch{epoch}_{name}.gif")
        x = device_batch(host, table.n_clips, cfg.clip_len, torch.float32,
                         "cpu")["x"][0, 0].numpy()
        want = jax_gif.batch2gif(x, int(host.label[0]),
                                 str(tmp_path / f"want{epoch}_"),
                                 classes=table.classes)
        frames, want = imageio.mimread(path), imageio.mimread(want)
        assert len(frames) == len(want) == cfg.clip_len
        for a, b in zip(frames, want):
            np.testing.assert_array_equal(a, b)


def test_a_failed_dump_warns_and_the_run_goes_on(tmp_path, monkeypatch,
                                                 capsys):
    """imageio blocked: the JAX package's warning on stderr, once an epoch,
    no GIF, and the summary of a run without the flag (the host clock's
    clips/s aside)."""
    plain = port_main.main(argv(tmp_path / "plain"))
    capsys.readouterr()
    monkeypatch.setitem(sys.modules, "imageio", None)
    try:
        jax_gif.batch2gif(np.zeros((2, 4, 4, 3), np.float32), 0,
                          str(tmp_path / "x_"))
    except Exception as e:  # noqa: BLE001
        want = (f"WARNING: --save_samples skipped "
                f"({type(e).__name__}: {e})")
    got = port_main.main(argv(tmp_path / "blocked", "--save_samples"))
    err = capsys.readouterr().err
    assert [ln for ln in err.splitlines() if "--save_samples" in ln] == [
        want, want]
    assert _samples(tmp_path) == []
    for k in plain:
        if k != "clips_per_sec":
            assert got[k] == plain[k], k


def test_only_process_zero_writes_the_gif(tmp_path, imageio):
    """cli.main on 2 gloo processes with --save_samples: process 0 writes
    the two epochs' GIFs (of its data shard's first batch), process 1
    opens nothing to write; both report the same metrics."""
    inp = tmp_path / "cli.json"
    inp.write_text(json.dumps(argv(tmp_path, "--save_samples")))
    outs, _ = launch(tmp_path, "cli", 2, inp)
    r0, r1 = (json.loads(o.read_text()) for o in outs)
    assert r1["writes"] == [], r1["writes"]
    gifs = [w for w in r0["writes"] if w.endswith(".gif")]
    assert len(gifs) == 2 and all("/samples/samples_train_epoch" in w
                                  for w in gifs)
    assert len(_samples(tmp_path)) == 2
    for k in ("loss", "train_accuracy", "synthetic_test_accuracy"):
        assert r0["summary"][k] == r1["summary"][k], k
