"""The port's zero-shot evaluation against the JAX package's, on the CPU
from numpy seeds: the k nearest classes, top-1 / top-5 accuracy with the
ground truth taken from the true embeddings, the seeded half-class split
protocol, the extraction loop (order, dropped zero-weight rows, lookahead
on and off) and the evaluation batch size."""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zeroshotvideoclassification_tpu.cli.main import (
    eval_batch_size as jax_eval_batch_size,
)
from zeroshotvideoclassification_tpu.eval import zeroshot as jax_eval
from zeroshotvideoclassification_tpu.ops.cdist import (
    topk_classes as jax_topk_classes,
)
from zeroshotvideoclassification_tpu_torch.cli.main import eval_batch_size
from zeroshotvideoclassification_tpu_torch.eval import (
    compute_accuracy,
    evaluate_dataset,
    extract_embeddings,
    split_protocol,
)
from zeroshotvideoclassification_tpu_torch.ops.cdist import topk_classes


def _unit(a):
    return (a / np.linalg.norm(a, axis=1, keepdims=True)).astype(np.float32)


def _embeddings(n=60, classes=12, noise=0.8, seed=0):
    """Class embeddings, true embeddings (one class each) and noisy
    predictions; random 300-d vectors keep every distance distinct."""
    rng = np.random.default_rng(seed)
    ce = _unit(rng.normal(size=(classes, 300)))
    labels = rng.integers(0, classes, n).astype(np.int32)
    true = ce[labels]
    pred = _unit(true + noise * rng.normal(size=(n, 300)) / np.sqrt(300) * 4)
    return pred, ce, labels, true


@pytest.mark.parametrize("k,classes", [(5, 12), (1, 12), (5, 3)])
def test_topk_classes_matches_jax(k, classes):
    """Identical indices in identical order (distinct distances), int32, k
    clamped to the class count."""
    pred, ce, _, _ = _embeddings(classes=classes, seed=1)
    want = np.asarray(jax_topk_classes(jnp.asarray(pred), jnp.asarray(ce),
                                       k=k))
    got = topk_classes(torch.from_numpy(pred), torch.from_numpy(ce), k=k)
    assert got.dtype == torch.int32
    assert tuple(got.shape) == (len(pred), min(k, classes))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("noise", [0.3, 0.8, 1.5])
def test_compute_accuracy_matches_jax(noise):
    pred, ce, _, true = _embeddings(noise=noise, seed=2)
    want = jax_eval.compute_accuracy(pred, ce, true)
    got = compute_accuracy(pred, ce, true)
    assert got == want  # the same counts over the same 60 samples
    assert 0 < got[0] <= got[1] <= 100
    with pytest.raises(ValueError, match="same number of samples"):
        compute_accuracy(pred[:-1], ce, true)


def test_ground_truth_comes_from_the_true_embeddings():
    """The target class is the argmin over the TRUE embedding's distances
    (reference/main.py:321-323), here true embeddings that are no class
    embedding themselves; held against the same rule in float64 numpy."""
    rng = np.random.default_rng(3)
    ce = _unit(rng.normal(size=(6, 300)))
    true = _unit(ce[rng.integers(0, 6, 40)] + 0.05 * rng.normal(
        size=(40, 300)))
    pred = _unit(true + 0.5 * rng.normal(size=true.shape))

    def dist(a):
        return 1 - a.astype(np.float64) @ ce.astype(np.float64).T

    y = dist(true).argmin(1)
    order = dist(pred).argsort(1)[:, :5]
    want = (float(np.mean(order[:, 0] == y) * 100),
            float(np.mean([t in o for t, o in zip(y, order)]) * 100))
    assert compute_accuracy(pred, ce, true) == want
    assert want[0] < 100.0  # some predictions do miss


@pytest.mark.parametrize("classes,n_splits", [(12, 10), (5, 4)])
def test_split_protocol_matches_jax(classes, n_splits):
    """Identical numbers: np.random.RandomState(split) draws the same
    half-class subsets on both sides."""
    pred, ce, labels, true = _embeddings(n=90, classes=classes, seed=4)
    want = jax_eval.split_protocol(pred, ce, labels, true, n_splits)
    got = split_protocol(pred, ce, labels, true, n_splits)
    assert got == want
    assert got["n_split_classes"] == classes // 2


def _batches(seed=5, n_batches=4, b=3):
    """Batches with zero-weight rows (a whole batch of them too)."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n_batches):
        weight = (rng.uniform(size=b) > 0.4).astype(np.float32)
        if i == 2:
            weight[:] = 0
        out.append({
            "x": rng.normal(size=(b, 1, 2, 4, 4, 3)).astype(np.float32),
            "z": rng.normal(size=(b, 300)).astype(np.float32),
            "label": rng.integers(0, 7, b).astype(np.int32),
            "weight": weight})
    return out


def _project(x):
    """A stand-in eval step: [B, 1, 2, 4, 4, 3] -> [B, 300]."""
    flat = x.reshape(x.shape[0], -1)
    return (flat[:, :, None] * (1 + np.arange(300, dtype=np.float32) / 300)
            ).sum(1)


@pytest.mark.parametrize("lookahead", [True, False])
def test_extract_embeddings_matches_jax(lookahead):
    """Same rows kept, in the same order, with the lookahead and without;
    every batch is dispatched before the one before it is collected."""
    data = _batches()
    want = jax_eval.extract_embeddings(
        lambda p, s, x: jnp.asarray(_project(np.asarray(x))), None, None,
        [{k: jnp.asarray(v) for k, v in b.items()} for b in data])
    order = []

    def step(x):
        order.append(("dispatch", len([o for o in order
                                       if o[0] == "dispatch"])))
        return torch.from_numpy(_project(x.numpy()))

    def source():
        for i, b in enumerate(data):
            order.append(("next", i))
            yield {k: torch.from_numpy(v) for k, v in b.items()}

    got = extract_embeddings(step, source(), lookahead=lookahead)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, np.asarray(w), rtol=1e-6)
        assert g.shape == np.asarray(w).shape
    kept = int(sum(b["weight"].sum() for b in data))
    assert got[0].shape == (kept, 300) and got[2].shape == (kept,)
    assert 0 < kept < 12
    assert [o for o in order if o[0] == "dispatch"] == [
        ("dispatch", i) for i in range(len(data))]


def test_evaluate_dataset_matches_jax():
    pred, ce, labels, true = _embeddings(n=24, classes=8, seed=6)
    data = [{"x": pred[i:i + 6], "z": true[i:i + 6],
             "label": labels[i:i + 6],
             "weight": np.ones(6, np.float32)} for i in range(0, 24, 6)]
    want = jax_eval.evaluate_dataset(
        lambda p, s, x: x, None, None,
        [{k: jnp.asarray(v) for k, v in b.items()} for b in data], ce,
        name="t")
    got = evaluate_dataset(
        lambda x: x, [{k: torch.from_numpy(v) for k, v in b.items()}
                      for b in data], ce, name="t")
    assert got == want and got["n_samples"] == 24


def test_eval_batch_size_matches_jax_over_a_grid():
    grid = itertools.product([1, 4, 16, 32, 64], [1, 2, 4, 25], [1, 2, 8],
                             [1, 2, 4], [1, 7, 100, 5000], [0, 32, 128])
    n = 0
    for bs, nc, n_data, pc, table_len, budget in grid:
        args = (bs * n_data, nc, n_data, pc, table_len, budget)
        assert eval_batch_size(*args) == jax_eval_batch_size(*args), args
        n += 1
    assert n == 5 * 4 * 3 * 3 * 4 * 3
    # one device, one process, the defaults: 128 clips per dispatch
    assert eval_batch_size(64, 25, 1, 1, 5000, 128) == 6
    assert eval_batch_size(64, 25, 1, 1, 4, 128) == 4
    assert eval_batch_size(64, 25, 1, 1, 5000, 0) == 2
