"""The port's multi-device dry run (dryrun.py) on the CPU under gloo: its
grid rule is the JAX dry run's (__graft_entry__.dryrun_multichip, whose
`tp = ...` expression is read from its source and evaluated), its mesh is
the JAX package's make_mesh of that shape, process 0 prints the JAX dry
run's line, and the loss of n processes is within rtol 1e-4 of one port
process on the same global batch and weights; its refusals."""

import ast
import inspect

import jax
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from zeroshotvideoclassification_tpu.parallel import (
    make_mesh as jax_make_mesh,
)
from zeroshotvideoclassification_tpu_torch import dryrun


@pytest.fixture(autouse=True)
def grad_enabled():
    """Another test module switches autograd off for its whole process when
    it is imported; the dry run differentiates."""
    with torch.enable_grad():
        yield


def jax_tp(n: int) -> int:
    """The JAX dry run's 'model' axis for n devices, from its own source."""
    fn = ast.parse(inspect.cleandoc("\n" + inspect.getsource(
        graft.dryrun_multichip)))
    rule = next(node.value for node in ast.walk(fn)
                if isinstance(node, ast.Assign)
                and [t.id for t in node.targets
                     if isinstance(t, ast.Name)] == ["tp"])
    return eval(compile(ast.Expression(rule), "<tp>", "eval"),
                {"n_devices": n})


@pytest.mark.parametrize("n", [1, 2, 3, 4, 6, 8, 16, 32, 36, 48, 64])
def test_grid_rule_is_the_jax_dry_runs(n):
    assert dryrun.grid_tp(n) == jax_tp(n)


@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_dry_run_on_n_gloo_processes(n, capfd):
    """n spawned processes: the mesh is the JAX package's make_mesh of the
    JAX rule's shape over n of the virtual devices, process 0 prints the
    JAX dry run's line once, and the global loss is within rtol 1e-4 of
    one process's step on the whole global batch (n = 1 through the
    command line)."""
    tp = jax_tp(n)
    want = dict(jax_make_mesh((n // tp, tp), ("data", "model"),
                              devices=jax.devices()[:n]).shape)
    if n == 1:
        res = dryrun.main(["1", "--device", "cpu"])
    else:
        res = dryrun.dryrun_multichip(n, "cpu")
    out = capfd.readouterr().out
    assert res["mesh"] == want
    lines = [ln for ln in out.splitlines() if "dryrun_multichip" in ln]
    assert lines == [f"dryrun_multichip OK: mesh={want} "
                     f"loss={res['loss']:.5f}"]
    assert np.isfinite(res["loss"])
    assert res["launches"] == {"bn_apply_relu": 0, "bn_apply_relu_bwd": 0}
    one = dryrun.dryrun_step(n, "cpu")
    assert one["emb"].shape == (max(n, 2), 300)
    np.testing.assert_allclose(res["loss"], one["loss"], rtol=1e-4)


def test_the_global_batch_is_the_jax_dry_runs():
    """The clips, targets, labels, weights and class embeddings, drawn in
    the JAX dry run's order from default_rng(0)."""
    src = inspect.getsource(graft.dryrun_multichip)
    for line in ("rng = np.random.default_rng(0)",
                 "x = rng.uniform(-0.5, 0, (b, 1, 4, 32, 32, 3))",
                 "z = rng.normal(size=(b, 300))",
                 "labels = rng.integers(0, 4, size=b)",
                 "class_embed = rng.normal(size=(4, 300))"):
        assert line in src, line
    x, z, labels, weight, ce = dryrun.global_batch(4)
    rng = np.random.default_rng(0)
    np.testing.assert_array_equal(
        x, rng.uniform(-0.5, 0, (4, 1, 4, 32, 32, 3)).astype(np.float32))
    want_z = rng.normal(size=(4, 300)).astype(np.float32)
    want_z /= np.linalg.norm(want_z, axis=1, keepdims=True)
    np.testing.assert_array_equal(z, want_z)
    np.testing.assert_array_equal(labels, rng.integers(0, 4, size=4))
    np.testing.assert_array_equal(weight, np.ones(4, np.float32))
    np.testing.assert_array_equal(
        ce, rng.normal(size=(4, 300)).astype(np.float32))
    assert dryrun.global_batch(1)[0].shape[0] == 2


def test_refusals(monkeypatch):
    """cuda without a GPU raises; NCCL over more processes than GPUs raises
    before any process starts; the CPU takes gloo only."""
    from zeroshotvideoclassification_tpu_torch.parallel import multihost

    def no_spawn(*a, **kw):
        raise AssertionError("processes started")

    monkeypatch.setattr(multihost, "run_local_ranks", no_spawn)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            dryrun.dryrun_multichip(2, "cuda")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="needs 2 GPUs, 1 are visible"):
        dryrun.dryrun_multichip(2, "cuda")
    with pytest.raises(ValueError, match="the CPU runs gloo"):
        dryrun.dryrun_multichip(2, "cpu", backend="nccl")
