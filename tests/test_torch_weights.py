"""Checkpoints and warm starts of the models beyond the mlp head, against
the JAX package's, on the CPU: the full train state (every section
strict) of mc3_18 with the linear head, of mc3_18 + mlp under fixconvs
and of C3D, written by either package, loads in the other bit for bit
(under fixconvs the backbone's Adam moments are zeros, as optax's after
stop_gradient); warm starts from a DavideA c3d.pickle and from the
reference's checkpoint.pth.tar of C3D and of resnet18 load what the JAX
package's warm_start loads; and the trainer finds ./assets/c3d.pickle, the
reference's path. Weights come from numpy and torch seeds."""

import argparse
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zeroshotvideoclassification_tpu.config import Config
from zeroshotvideoclassification_tpu.models import get_network as jax_network
from zeroshotvideoclassification_tpu.train import (
    create_train_state,
    load_checkpoint as jax_load_checkpoint,
    make_optimizer as jax_make_optimizer,
    save_checkpoint as jax_save_checkpoint,
    warm_start as jax_warm_start,
)
from zeroshotvideoclassification_tpu_torch.cli.main import Experiment
from zeroshotvideoclassification_tpu_torch.config import Config as PortConfig
from zeroshotvideoclassification_tpu_torch.models import bridge, get_network
from zeroshotvideoclassification_tpu_torch.models import layers as PL
from zeroshotvideoclassification_tpu_torch.models.c3d import CONVS
from zeroshotvideoclassification_tpu_torch.train import (
    TrainState,
    load_checkpoint,
    make_optimizer,
    make_train_step,
    save_checkpoint,
    warm_start,
)

from test_torch_c3d import c3d, port_c3d  # noqa: F401  (a fixture)
from test_torch_train import (
    as_torch,
    assert_trees_close,
    batches,
    jax_weights,
    port_model,
)
from torch_helpers import remove_large_files

N_TENSORS = 2 * len(CONVS) + 2  # C3D's backbone: weights and biases


@pytest.fixture(autouse=True)
def drop_large_files(tmp_path):
    """Delete the test's large files when it ends
    (torch_helpers.remove_large_files)."""
    yield
    remove_large_files(tmp_path)


@pytest.fixture(autouse=True)
def grad_enabled():
    """Another test module switches autograd off for its whole process when
    it is imported; the tests here differentiate."""
    with torch.enable_grad():
        yield


CONFIG_JSON = json.dumps({"network": "mc3_18"})


def cross_checkpoints(jax_model, port, tmp_path, port_steps=()):
    """Checkpoints of `port` (a ZeroShotModel like `jax_model`) across both
    packages, strict on every section both ways: a JAX TrainState of the
    same weights (optax's init) written by the JAX package loads into a
    fresh optimizer of the port and holds bit for bit; then the port takes
    `port_steps` (args of its train step) and writes its state, member for
    member the JAX file's keys, dtypes and shapes, and the JAX package's
    strict load restores what the port holds. -> the JAX state loaded from
    the port's file."""
    params, state = bridge.to_jax(port.state_dict())
    state = {"backbone": {}, **state}  # C3D's empty BN state
    opt = jax_make_optimizer(1e-3)
    ts = create_train_state(jax_model, opt, jax.random.PRNGKey(0))
    ts = dataclasses.replace(ts, params=jax.tree.map(jnp.asarray, params),
                             model_state=jax.tree.map(jnp.asarray, state))
    jax_path, port_path = str(tmp_path / "jax.npz"), str(tmp_path / "p.npz")
    jax_save_checkpoint(jax_path, ts, 1, 2.5, CONFIG_JSON)
    lopt = make_optimizer(port.parameters(), 1e-3)
    load_checkpoint(jax_path, port, lopt)
    want = bridge.from_jax(ts.params, ts.model_state)
    for k, v in port.state_dict().items():
        assert k.endswith("num_batches_tracked") or torch.equal(v, want[k])
    assert int(lopt.count) == 0 and all(
        not lopt.state[p]["exp_avg"].any() for p in port.parameters())
    # a fresh optimizer: Adam's state appears where it steps
    popt = make_optimizer(port.parameters(), 1e-3)
    step = make_train_step(port, popt, compute_dtype=torch.float32)
    for args in port_steps:
        step(*as_torch(*args))
    save_checkpoint(port_path, TrainState(port, popt, step=len(port_steps)),
                    1, 2.5, CONFIG_JSON)
    with np.load(jax_path) as a, np.load(port_path) as b:
        assert set(a.files) == set(b.files)
        for k in a.files:
            assert (a[k].dtype, a[k].shape) == (b[k].dtype, b[k].shape), k
    got, meta = jax_load_checkpoint(port_path, ts)
    assert meta["epoch"] == 1 and int(got.step) == len(port_steps)
    want_p, want_s = bridge.to_jax(port.state_dict())
    assert_trees_close(jax.tree.map(np.asarray, got.params), want_p, 0.0)
    assert_trees_close(jax.tree.map(np.asarray, got.model_state),
                       {"backbone": {}, **want_s}, 0.0)
    mu, nu, count = bridge.adam_to_jax(port, popt)
    adam = got.opt_state.inner_state.inner_state[0]
    assert int(adam.count) == count
    assert_trees_close(jax.tree.map(np.asarray, adam.mu), mu, 0.0)
    assert_trees_close(jax.tree.map(np.asarray, adam.nu), nu, 0.0)
    for f in (jax_path, port_path):
        os.unlink(f)
    return got


@pytest.mark.parametrize("case", ["linear", "fixconvs"])
def test_checkpoints_cross_both_ways(case, tmp_path):
    """mc3_18 with the linear head, or the mlp head under fixconvs, two f32
    steps: under fixconvs Adam never touches the backbone, its moments are
    written as zeros (optax's, after stop_gradient) and its parameters
    stay as loaded."""
    cfg = {"head": "linear"} if case == "linear" else {"fixconvs": True}
    model, params, state = jax_weights("mc3_18", seed=3, **cfg)
    port = port_model(params, state, "mc3_18", **cfg)
    data, ce = batches(2)
    got = cross_checkpoints(model, port, tmp_path,
                            [(*d, ce) for d in data])
    adam = got.opt_state.inner_state.inner_state[0]
    assert int(adam.count) == 2
    head_mu = bridge.flatten(jax.tree.map(np.asarray, adam.mu["head"]))
    assert all(np.abs(v).max() > 0 for v in head_mu.values())
    if case == "fixconvs":
        for tree in (adam.mu, adam.nu):
            assert all(float(jnp.abs(v).max()) == 0.0
                       for v in jax.tree.leaves(tree["backbone"]))
        assert_trees_close(jax.tree.map(np.asarray, got.params["backbone"]),
                           params["backbone"], 0.0)


def test_warm_start_from_a_reference_checkpoint_of_resnet18(tmp_path):
    """The reference fork's checkpoint.pth.tar of r3d_18 + the linear head
    (backbone under `module.model.`, `module.regressor.*`): the port's
    warm_start and the JAX package's load the same tensors, all of them."""
    import argparse

    src = get_network(PortConfig(network="resnet18"))
    PL.init_weights(src, torch.Generator().manual_seed(9))
    sd = src.state_dict()
    path = str(tmp_path / "checkpoint.pth.tar")
    torch.save({"state_dict": {f"module.{k}": v for k, v in sd.items()},
                "opt": argparse.Namespace(network="resnet18"),
                "accuracy": 20.0}, path)
    m = get_network(PortConfig(network="resnet18"))
    n = warm_start(path, m)
    model = jax_network(Config(network="resnet18"))
    params, state = jax.tree.map(np.array, jax.jit(model.init)(
        jax.random.PRNGKey(0)))
    params, state, jax_n = jax_warm_start(path, params, state,
                                          network="r3d_18", head="linear")
    counted = [k for k in sd if not k.endswith("num_batches_tracked")]
    assert n == jax_n == len(counted)
    want = bridge.from_jax(params, state)
    for k in counted:
        assert torch.equal(m.state_dict()[k], sd[k]), k
        assert torch.equal(want[k], sd[k]), k


def test_c3d_checkpoints_cross_both_ways(c3d, tmp_path):
    """The full train state of C3D (every section strict) written by
    either package loads in the other bit for bit; the port writes zero
    moments for the parameters its fresh optimizer has not stepped."""
    model, params = c3d
    got = cross_checkpoints(model, port_c3d(params), tmp_path)
    assert int(got.opt_state.inner_state.inner_state[0].count) == 0


@pytest.fixture(scope="module")
def c3d_pickle(tmp_path_factory):
    """A synthetic c3d.pickle in DavideA/c3d-pytorch's layout (conv1 ...
    conv5b, fc6, fc7, fc8 of 487 classes; torch's legacy, non-zip format),
    seeded; -> (path, state_dict)."""
    g = torch.Generator().manual_seed(7)
    shapes = {f"{n}.weight": (co, ci, 3, 3, 3) for n, ci, co in CONVS}
    shapes.update({f"{n}.bias": (co,) for n, _, co in CONVS})
    shapes.update({"fc6.weight": (4096, 8192), "fc6.bias": (4096,),
                   "fc7.weight": (4096, 4096), "fc7.bias": (4096,),
                   "fc8.weight": (487, 4096), "fc8.bias": (487,)})
    sd = {k: torch.randn(s, generator=g) * 0.01 for k, s in shapes.items()}
    path = tmp_path_factory.mktemp("c3d_pickle") / "assets" / "c3d.pickle"
    path.parent.mkdir()
    torch.save(sd, str(path), _use_new_zipfile_serialization=False)
    yield str(path), sd
    os.unlink(path)


def test_warm_start_from_a_c3d_pickle(c3d_pickle):
    """Every backbone tensor loads (fc7 and fc8 skipped, the head keeps its
    init), the same ones and as many as the JAX package's warm_start."""
    path, sd = c3d_pickle
    m = get_network(PortConfig(network="c3d"))
    head = m.regressor.weight.detach().clone()
    assert warm_start(path, m) == N_TENSORS
    model = jax_network(Config(network="c3d"))
    params, state = jax.tree.map(np.array, jax.jit(model.init)(
        jax.random.PRNGKey(0)))
    params, _, jax_n = jax_warm_start(path, params, state, network="c3d",
                                      head="c3d")
    assert jax_n == N_TENSORS
    want = bridge.from_jax(params, {})
    got = m.state_dict()
    for k, v in got.items():
        if k.startswith("regressor."):
            continue
        assert torch.equal(v, sd[k]) and torch.equal(want[k], sd[k]), k
    assert torch.equal(m.regressor.weight, head)


def test_pretrained_c3d_is_loaded_from_the_references_path(c3d_pickle,
                                                           monkeypatch,
                                                           capsys):
    """Without --nopretrained the trainer loads ./assets/c3d.pickle into a
    C3D, as the reference and the JAX trainer do."""
    path, sd = c3d_pickle
    root = os.path.dirname(os.path.dirname(path))
    monkeypatch.chdir(root)
    cfg = PortConfig(network="c3d", dataset="synthetic",
                     save_path=os.path.join(root, "runs"),
                     pretrained_dir=os.path.join(root, "none"))
    exp = Experiment(cfg, {"training": [], "testing": []}, device="cpu")
    exp.log.close()
    assert (f"PRETRAINED: loaded {N_TENSORS} tensors from "
            f"./assets/c3d.pickle") in capsys.readouterr().out
    assert torch.equal(exp.model.conv5b.weight, sd["conv5b.weight"])


def test_warm_start_from_a_reference_checkpoint_of_c3d(c3d, tmp_path):
    """The reference's checkpoint.pth.tar of C3D (`module.conv1.weight` ...
    `module.regressor.bias`): every tensor, on both sides."""
    _, params = c3d
    sd = port_c3d(params).state_dict()
    path = str(tmp_path / "checkpoint.pth.tar")
    torch.save({"state_dict": {f"module.{k}": v for k, v in sd.items()},
                "opt": argparse.Namespace(network="c3d"),
                "accuracy": 20.0}, path)
    m = get_network(PortConfig(network="c3d"))
    assert warm_start(path, m) == N_TENSORS + 2
    model = jax_network(Config(network="c3d"))
    p0, s0 = jax.tree.map(np.array, jax.jit(model.init)(
        jax.random.PRNGKey(0)))
    p1, _, jax_n = jax_warm_start(path, p0, s0, network="c3d", head="c3d")
    assert jax_n == N_TENSORS + 2
    assert_trees_close(p1, params, 0.0)
    for k, v in m.state_dict().items():
        assert torch.equal(v, sd[k]), k
    os.unlink(path)
