"""The still-image slice as a whole, on the CPU at a tiny size: train on an
image table with the halved batch, then evaluate a synthetic video test
table zero-shot, through Experiment.run of both packages from the same
weights (models/bridge), the same seeded Adam state and byte-identical host
batches; and --evaluate on the weights the experiment holds."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zeroshotvideoclassification_tpu.cli import main as jax_main
from zeroshotvideoclassification_tpu.config import Config as JaxConfig
from zeroshotvideoclassification_tpu.data.datasets import (
    VideoTable as JaxVideoTable,
)
from zeroshotvideoclassification_tpu.data.synthetic import (
    build_synthetic_datasets as jax_synthetic,
)
from zeroshotvideoclassification_tpu_torch.cli.main import Experiment
from zeroshotvideoclassification_tpu_torch.config import Config
from zeroshotvideoclassification_tpu_torch.data.datasets import VideoTable
from zeroshotvideoclassification_tpu_torch.data.synthetic import (
    build_synthetic_datasets,
)
from zeroshotvideoclassification_tpu_torch.models import bridge
from zeroshotvideoclassification_tpu_torch.train import save_checkpoint

from test_torch_train import jax_weights, seeded_moments
from torch_helpers import remove_large_files

SIZE, CLIP_LEN = 32, 4


@pytest.fixture(autouse=True)
def drop_large_files(tmp_path):
    """Delete the test's large files when it ends
    (torch_helpers.remove_large_files)."""
    yield
    remove_large_files(tmp_path)


@pytest.fixture(autouse=True)
def grad_enabled():
    """Another test module switches autograd off for its whole process when
    it is imported; the trainer differentiates."""
    with torch.enable_grad():
        yield


@pytest.fixture(autouse=True)
def one_device_mesh(monkeypatch):
    """The tests run on a virtual mesh of 8 CPU devices, over which the JAX
    trainer would spread a global batch of 8 x bs; the port has one device.
    Give the JAX trainer a mesh of one device, so that both train on the
    same batches."""
    real = jax_main.make_mesh
    monkeypatch.setattr(
        jax_main, "make_mesh",
        lambda shape, axes: real((1,), ("data",), devices=jax.devices()[:1]))


@pytest.fixture(scope="module")
def image_files(tmp_path_factory):
    """Seven seeded images of several sizes and one path that does not
    exist, with their labels."""
    import cv2

    root = tmp_path_factory.mktemp("sun")
    rng = np.random.default_rng(0)
    paths = []
    for i, hw in enumerate([(200, 260), (180, 180), (120, 150), (300, 620),
                            (230, 240), (190, 400), (260, 200)]):
        base = rng.integers(0, 256, (hw[0] // 8 + 1, hw[1] // 8 + 1, 3))
        img = np.kron(base, np.ones((8, 8, 1)))[:hw[0], :hw[1]].astype(
            np.uint8)
        p = str(root / f"im{i}.png")
        cv2.imwrite(p, cv2.cvtColor(img, cv2.COLOR_RGB2BGR))
        paths.append(p)
    paths.append(str(root / "missing.jpg"))
    return paths, np.asarray([0, 1, 2, 0, 1, 2, 0, 1], np.int32)


def _configs(tmp_path, aa, **kw):
    base = dict(dataset="sun2both", network="r2plus1d_18", bs=8, n_epochs=1,
                size=SIZE, clip_len=CLIP_LEN, canvas_hw=(96, 128),
                compute_dtype="float32", nopretrained=True, progressbar=False,
                sun_antialias=aa, class_total=8, decode_workers=2, seed=3,
                **kw)
    return (JaxConfig(save_path=str(tmp_path / "jax"), **base),
            Config(save_path=str(tmp_path / "port"), **base))


def _datasets(image_files, jcfg, pcfg):
    paths, labels = image_files
    rng = np.random.default_rng(1)
    emb = rng.normal(size=(3, 300)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    kw = dict(name="sun", fnames=np.asarray(paths, object), label_idx=labels,
              classes=["a", "b", "c"], class_embed=emb, loader="image",
              is_validation=False, n_clips=1)
    synth = dict(dataset="synthetic", class_total=8, clip_len=CLIP_LEN,
                 size=SIZE)
    return ({"training": [JaxVideoTable(**kw)],
             "testing": jax_synthetic(JaxConfig(**synth))["testing"]},
            {"training": [VideoTable(**kw)],
             "testing": build_synthetic_datasets(Config(**synth))["testing"]})


def _experiments(tmp_path, image_files, aa, **kw):
    """Both packages' experiments on the same tables, holding the same
    weights (warmed BN statistics) and the same seeded Adam state."""
    jcfg, pcfg = _configs(tmp_path, aa, **kw)
    jdata, pdata = _datasets(image_files, jcfg, pcfg)
    _, params, state = jax_weights(
        seed=5, warm_shape=(2, 1, CLIP_LEN, SIZE, SIZE, 3))
    mu, nu = seeded_moments(params, 6)
    jexp = jax_main.Experiment(jcfg, jdata)
    guard = jexp.state.opt_state.inner_state
    adam = guard.inner_state[0]._replace(
        count=jnp.asarray(1000, jnp.int32), mu=jax.tree.map(jnp.asarray, mu),
        nu=jax.tree.map(jnp.asarray, nu))
    opt_state = jexp.state.opt_state._replace(inner_state=guard._replace(
        inner_state=(adam,) + tuple(guard.inner_state[1:])))
    jexp.state = dataclasses.replace(
        jexp.state, params=jax.tree.map(jnp.asarray, params),
        model_state=jax.tree.map(jnp.asarray, state), opt_state=opt_state)
    pexp = Experiment(pcfg, pdata, device="cpu")
    pexp.model.load_state_dict(bridge.from_jax(params, state), strict=True)
    bridge.adam_from_jax(pexp.model, pexp.optimizer, mu, nu, 1000)
    return jexp, pexp


@pytest.mark.parametrize("aa", [True, False])
def test_sun_training_and_evaluation_match_jax(tmp_path, image_files, aa,
                                               capsys):
    """One epoch on 8 images (one missing) in batches of 4 = bs // 2, then
    the zero-shot evaluation of 16 synthetic test videos of 4 classes.
    Held: the mean training loss within rtol 1e-4 (the bar of
    test_train_steps_match_jax, from a seeded Adam state; at 2 clips a
    step the late layers' batch statistics span 8 positions and the losses
    part by 1.4e-4), the
    train accuracy, top-1 / top-5 and the four split numbers equal (counts
    over the same samples; the test embeddings of the two packages agree to
    ~1e-4 and no ranking is that close), the best accuracy equal."""
    jexp, pexp = _experiments(tmp_path, image_files, aa)
    assert pexp.train_bs == jexp._image_train_batch()[0] == 4
    assert pexp.global_bs == jexp.global_bs == 8
    want = jexp.run()
    got = pexp.run()
    out = capsys.readouterr().out
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-4)
    assert got["train_accuracy"] == want["train_accuracy"]
    assert got["synthetic_test_accuracy"] == want["synthetic_test_accuracy"]
    assert got["best_accuracy"] == want["best_accuracy"]
    assert isinstance(got["best_accuracy"], float)
    assert pexp.train_step.state.step == 2  # 8 images / (8 // 2)
    assert "SYNTHETIC_TEST Epoch 0: Test accuracy:" in out
    assert "Split accuracy" in out and "Best accuracy" in out
    # the scalars and the two csv files, line for line
    for name in ("synthetic_test_accuracy.csv",
                 "synthetic_test_accuracy_splits.csv"):
        with open(os.path.join(pexp.savename, name)) as f, open(
                os.path.join(jexp.savename, name)) as g:
            assert f.read() == g.read(), name
    import json

    def scalars(exp):
        with open(os.path.join(exp.savename, "metrics.jsonl")) as f:
            rows = [json.loads(line) for line in f]
        return {(r["tag"], r["step"]): r["value"] for r in rows
                if r["tag"].startswith("synthetic_test/")}

    assert scalars(pexp) == scalars(jexp) and len(scalars(pexp)) == 5


def test_evaluate_flag_evaluates_the_held_weights(tmp_path, image_files,
                                                  capsys):
    """--evaluate: no training, one evaluation of the weights the
    experiment holds with the evaluation's clip count (4 per video), logged
    under evaluation/; the numbers equal the JAX package's."""
    jexp, pexp = _experiments(tmp_path, image_files, True, evaluate=True)
    want, got = jexp.run(), pexp.run()
    assert "loss" not in got and pexp.train_step.state.step == 0
    assert got == want and got["best_accuracy"] == got[
        "synthetic_test_accuracy"]
    assert pexp.savename.endswith(os.path.join("", "evaluation"))
    assert "evaluating fresh init" in capsys.readouterr().out
    assert not [f for f in os.listdir(pexp.savename)
                if f.startswith("train_samples_")]
    # with a checkpoint at the run's path, --evaluate evaluates it (strict
    # on the weights and BN statistics)
    ckpt = os.path.join(os.path.dirname(pexp.savename), "checkpoint.npz")
    with torch.no_grad():
        for p in pexp.model.parameters():
            p.add_(0.01)
    save_checkpoint(ckpt, pexp.train_step.state, 0, 1.0)
    loaded = Experiment(pexp.config, pexp.datasets, device="cpu")
    assert f"LOADED CHECKPOINT: {ckpt}" in capsys.readouterr().out
    for k, v in pexp.model.state_dict().items():
        assert torch.equal(loaded.model.state_dict()[k], v), k


def test_split_protocol_is_skipped_under_four_classes(tmp_path, image_files):
    jcfg, pcfg = _configs(tmp_path, True, evaluate=True)
    _, pdata = _datasets(image_files, jcfg, pcfg)
    table = pdata["testing"][0]
    keep = table.label_idx < 3
    small = dataclasses.replace(
        table, fnames=table.fnames[keep], label_idx=table.label_idx[keep],
        classes=table.classes[:3], class_embed=table.class_embed[:3])
    exp = Experiment(pcfg, {"training": [], "testing": [small]},
                     device="cpu")
    out = exp.evaluate(small, 0)
    assert set(out) == {"accuracy", "accuracy_top5"}
    assert not os.path.exists(os.path.join(
        exp.savename, "synthetic_test_accuracy_splits.csv"))
    assert exp.run()["best_accuracy"] == out["accuracy"]
