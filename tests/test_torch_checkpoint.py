"""The port's checkpoints against the JAX package's, on the CPU: an npz
written by either package loads in the other with bit-equal tensors and
the same keys and dtypes, after optimizer updates with NaN steps among
them (so that inject_hyperparams' count of updates and Adam's count
differ); strict loads refuse another network; warm_start takes a partial
npz and torch sources (.pth with `module.` prefixes, torchvision backbone
weights) as the JAX package's warm_start does; the asynchronous writer
keeps its order and re-raises a failed write; the profiler hook writes a
trace. Weights come from numpy seeds; mc3_18 keeps the files small."""

import argparse
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from zeroshotvideoclassification_tpu.config import Config as JaxConfig
from zeroshotvideoclassification_tpu.models import get_network as jax_network
from zeroshotvideoclassification_tpu.train.checkpoint import (
    load_checkpoint as jax_load_checkpoint,
    save_checkpoint as jax_save_checkpoint,
    warm_start as jax_warm_start,
)
from zeroshotvideoclassification_tpu.train.optimizer import (
    make_optimizer as jax_make_optimizer,
    set_lr as jax_set_lr,
)
from zeroshotvideoclassification_tpu.train.step import (
    TrainState as JaxTrainState,
)
from zeroshotvideoclassification_tpu_torch.config import Config
from zeroshotvideoclassification_tpu_torch.models import bridge, get_network
from zeroshotvideoclassification_tpu_torch.models.layers import init_weights
from zeroshotvideoclassification_tpu_torch.train import (
    TrainState,
    load_checkpoint,
    make_optimizer,
    read_meta,
    save_checkpoint,
    warm_start,
)
from zeroshotvideoclassification_tpu_torch.train.async_ckpt import (
    AsyncCheckpointer,
)
from zeroshotvideoclassification_tpu_torch.utils.profiler import (
    StepStats,
    device_trace,
)

from torch_helpers import randomize_bn, remove_large_files

ARCH = "mc3_18"
CONFIG_JSON = json.dumps({"network": ARCH, "lr": 5e-4})


@pytest.fixture(autouse=True)
def drop_checkpoints(tmp_path):
    """Delete the test's checkpoint files (and any other large file) when it
    ends: full-width models make files of 140-400 MB each
    (torch_helpers.remove_large_files)."""
    yield
    remove_large_files(tmp_path)


def _jax_params(arch, seed):
    model = jax_network(JaxConfig(network=arch, head="mlp"))
    params, state = jax.jit(model.init)(jax.random.PRNGKey(seed))
    params = jax.tree.map(np.array, params)
    state = jax.tree.map(np.array, state)
    randomize_bn(params, state, np.random.default_rng(seed))
    return params, state


@pytest.fixture(scope="module")
def jax_state():
    """A JAX TrainState of mc3_18 + mlp after four updates from seeded
    gradients, the second and the fourth with a NaN (Adam's count 2,
    updates 4, total_notfinite 2, notfinite_count 1, last_finite False),
    at a learning rate of 5e-4 set through the JAX package's set_lr."""
    params, state = _jax_params(ARCH, 0)
    opt = jax_make_optimizer(1e-3)
    opt_state = jax_set_lr(opt.init(params), 5e-4)
    rng = np.random.default_rng(1)
    p = jax.tree.map(jnp.asarray, params)
    for k in range(4):
        grads = jax.tree.map(
            lambda a: jnp.asarray(rng.normal(0, 1e-2, a.shape), jnp.float32),
            p)
        if k % 2 == 1:
            leaf = grads["head"]["fc1"]["w"]
            grads["head"]["fc1"]["w"] = leaf.at[0, 0].set(jnp.nan)
        updates, opt_state = opt.update(grads, opt_state, p)
        p = optax.apply_updates(p, updates)
    ts = JaxTrainState(params=jax.tree.map(np.array, p), model_state=state,
                       opt_state=jax.tree.map(np.array, opt_state),
                       step=jnp.asarray(4, jnp.int32))
    assert int(ts.opt_state.count) == 4
    assert int(ts.opt_state.inner_state.inner_state[0].count) == 2
    assert int(ts.opt_state.inner_state.total_notfinite) == 2
    return ts


def _port(arch=ARCH):
    m = get_network(Config(network=arch, head="mlp"))
    init_weights(m, torch.Generator().manual_seed(5))
    return m, make_optimizer(m.parameters(), 1e-3)


def _assert_holds(model, opt, ts):
    """The port's model and optimizer hold the JAX state bit for bit."""
    want = bridge.from_jax(ts.params, ts.model_state)
    got = model.state_dict()
    assert set(got) == set(want)
    for k, v in want.items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(got[k], v), k
    inner = ts.opt_state.inner_state
    adam = inner.inner_state[0]
    mu = bridge.from_jax(adam.mu, {})
    nu = bridge.from_jax(adam.nu, {})
    for k, p in model.named_parameters():
        assert torch.equal(opt.state[p]["exp_avg"], mu[k]), k
        assert torch.equal(opt.state[p]["exp_avg_sq"], nu[k]), k
        assert opt.state[p]["step"] is opt.count
    assert int(opt.count) == int(adam.count) == 2
    assert int(opt.total_notfinite) == int(inner.total_notfinite) == 2
    assert int(opt.notfinite_count) == int(inner.notfinite_count) == 1
    assert bool(opt.last_finite) is bool(inner.last_finite) is False
    assert np.float32(opt.param_groups[0]["lr"]) == np.float32(5e-4)


def test_jax_checkpoint_loads_bit_equal_in_the_port(jax_state, tmp_path):
    path = str(tmp_path / "jax.npz")
    jax_save_checkpoint(path, jax_state, epoch=2, accuracy=12.5,
                        config_json=CONFIG_JSON)
    m, opt = _port()
    meta = load_checkpoint(path, m, opt)
    assert (meta["epoch"], meta["accuracy"], meta["step"]) == (2, 12.5, 4)
    assert meta["config"] == json.loads(CONFIG_JSON)
    assert read_meta(path)["epoch"] == 2
    _assert_holds(m, opt, jax_state)


def test_port_checkpoint_loads_bit_equal_in_jax(jax_state, tmp_path):
    """The port writes what it loaded: JAX's strict load of all three
    sections restores every leaf bit for bit, `count` (all updates) among
    them from Adam's count + total_notfinite, and the two files hold the
    same members with the same dtypes and shapes."""
    jax_path, port_path = str(tmp_path / "jax.npz"), str(tmp_path / "p.npz")
    jax_save_checkpoint(jax_path, jax_state, 2, 12.5, CONFIG_JSON)
    m, opt = _port()
    load_checkpoint(jax_path, m, opt)
    save_checkpoint(port_path, TrainState(m, opt, step=4), 2, 12.5,
                    CONFIG_JSON)
    with np.load(jax_path) as a, np.load(port_path) as b:
        assert set(a.files) == set(b.files)
        for k in a.files:
            if k != "__meta__":
                assert (a[k].dtype, a[k].shape) == (b[k].dtype, b[k].shape), k
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    template = jax.tree.map(np.zeros_like, jax_state)
    got, meta = jax_load_checkpoint(port_path, template)
    assert meta["epoch"] == 2 and meta["config"] == json.loads(CONFIG_JSON)
    assert int(got.step) == 4
    for sec in ("params", "model_state", "opt_state"):
        want = jax.tree_util.tree_leaves_with_path(getattr(jax_state, sec))
        have = jax.tree_util.tree_leaves(getattr(got, sec))
        assert len(want) == len(have)
        for (path, w), h in zip(want, have):
            assert np.asarray(h).dtype == np.asarray(w).dtype, path
            np.testing.assert_array_equal(np.asarray(h), np.asarray(w),
                                          err_msg=str(path))


@pytest.mark.parametrize("case", ["jax_r3d_into_r2plus1d",
                                  "mc3_into_r3d_with_optimizer"])
def test_strict_load_refuses_another_network(case, jax_state, tmp_path):
    """A checkpoint of another network loads into nothing: ValueError, and
    the model and optimizer stay as they were."""
    path = str(tmp_path / "other.npz")
    arch = "r2plus1d_18" if case == "jax_r3d_into_r2plus1d" else "r3d_18"
    m, opt = _port(arch)
    if case == "jax_r3d_into_r2plus1d":
        params, state = _jax_params("r3d_18", 2)
        jax_save_checkpoint(path, JaxTrainState(params, state, {}, 0), 0, 1.0)
        with pytest.raises(ValueError, match="does not match"):
            load_checkpoint(path, m)
    else:
        jax_save_checkpoint(path, jax_state, 2, 12.5)
        with pytest.raises(ValueError, match="does not match"):
            load_checkpoint(path, m, opt)
    fresh, _ = _port(arch)
    for k, v in fresh.state_dict().items():
        assert torch.equal(m.state_dict()[k], v), k
    assert not opt.state and int(opt.count) == 0


def test_warm_start_loads_a_partial_npz(jax_state, tmp_path):
    """Half of the parameters and none of the BN statistics: exactly those
    load, the rest keeps the init; the JAX warm_start counts the same."""
    full = str(tmp_path / "full.npz")
    jax_save_checkpoint(full, jax_state, 2, 12.5)
    with np.load(full) as z:
        names = sorted(k for k in z.files if k.startswith("params::"))
        kept = {k: z[k] for k in names[::2]}
        kept["__meta__"] = z["__meta__"]
        kept["__step__"] = z["__step__"]
    part = str(tmp_path / "part.npz")
    np.savez(part, **kept)
    m, _ = _port()
    before = {k: v.clone() for k, v in m.state_dict().items()}
    n = warm_start(part, m)
    _, jax_n = jax_warm_start(part, jax_state.params)
    assert n == jax_n == len(names[::2])
    want = bridge.from_jax(jax_state.params, jax_state.model_state)
    loaded = {bridge.torch_key(k.split("::", 1)[1]) for k in names[::2]}
    for k, v in m.state_dict().items():
        assert torch.equal(v, want[k] if k in loaded else before[k]), k


@pytest.mark.parametrize("source", ["reference", "torchvision"])
def test_warm_start_loads_torch_sources(source, tmp_path):
    """A .pth written here from a seeded state_dict: the reference fork's
    checkpoint.pth.tar ({'state_dict' with DataParallel `module.`
    prefixes, 'opt', 'accuracy'}), whose keys are the port's, or a
    torchvision backbone (no `model.`, a classifier `fc.*` that is
    skipped). The port's warm_start and the JAX package's (through
    models/porting.py) load the same tensors, and the same number."""
    src, _ = _port()
    g = torch.Generator().manual_seed(9)
    with torch.no_grad():
        for k, v in src.state_dict().items():
            if v.is_floating_point():
                v.copy_(torch.randn(v.shape, generator=g))
                if k.endswith("running_var"):
                    v.abs_().add_(0.5)
    sd = {k: v for k, v in src.state_dict().items()}
    if source == "reference":
        path = str(tmp_path / "checkpoint.pth.tar")
        torch.save({"state_dict": {f"module.{k}": v for k, v in sd.items()},
                    "opt": argparse.Namespace(network=ARCH, lr=1e-3),
                    "accuracy": 31.5}, path)
    else:
        path = str(tmp_path / f"{ARCH}.pth")
        tv = {k[len("model."):]: v for k, v in sd.items()
              if k.startswith("model.")}
        tv["fc.weight"] = torch.randn(400, 512, generator=g)
        tv["fc.bias"] = torch.randn(400, generator=g)
        torch.save(tv, path)
    m, _ = _port()
    before = {k: v.clone() for k, v in m.state_dict().items()}
    n = warm_start(path, m)
    params, state = _jax_params(ARCH, 3)
    params, state, jax_n = jax_warm_start(path, params, state, network=ARCH,
                                          head="mlp")
    assert n == jax_n
    counted = [k for k in sd if not k.endswith("num_batches_tracked")
               and (source == "reference" or k.startswith("model."))]
    assert n == len(counted)
    want = bridge.from_jax(params, state)
    for k, v in m.state_dict().items():
        if k.endswith("num_batches_tracked"):
            continue
        if k in counted:
            assert torch.equal(v, sd[k]) and torch.equal(v, want[k]), k
        else:  # the torchvision file has no head
            assert torch.equal(v, before[k]), k


class _Payload:
    """An object a pickle can carry besides tensors (a file from elsewhere
    could carry code the same way)."""


def test_warm_start_refuses_c3d_pickles(tmp_path):
    """A c3d.pickle is read with torch.load(weights_only=True): one that
    carries any object besides tensors and containers is refused, and the
    model keeps its weights (test_torch_weights.py loads a C3D one)."""
    import pickle

    path = str(tmp_path / "c3d.pickle")
    m = _port()[0]
    sd = {f"model.{k}": v for k, v in m.state_dict().items()}
    torch.save({**sd, "payload": _Payload()}, path)
    before = {k: v.clone() for k, v in m.state_dict().items()}
    with pytest.raises(pickle.UnpicklingError, match="Weights only load"):
        warm_start(path, m)
    for k, v in m.state_dict().items():
        assert torch.equal(v, before[k]), k


def test_async_checkpointer_keeps_order_and_reraises(tmp_path):
    """Writes land in the order submitted (the last one wins the file),
    a failed write re-raises at the next wait(), and a closed writer takes
    nothing more."""
    m, opt = _port()
    from zeroshotvideoclassification_tpu_torch.train import host_state

    state = host_state(TrainState(m, opt, step=0))
    path = str(tmp_path / "last.npz")
    ck = AsyncCheckpointer()
    for epoch in range(3):
        ck.submit(path, state, epoch, float(epoch), CONFIG_JSON)
    ck.wait(timeout=120)
    assert read_meta(path)["epoch"] == 2
    blocker = tmp_path / "a_file"
    blocker.write_text("not a directory")
    ck.submit(str(blocker / "x.npz"), state, 0, 0.0)
    with pytest.raises(OSError):
        ck.wait(timeout=120)
    ck.close(timeout=120)
    assert not ck._worker.is_alive()
    with pytest.raises(RuntimeError, match="closed"):
        ck.submit(path, state, 4, 0.0)
    assert not [f for f in os.listdir(tmp_path) if f.endswith(".tmp")]


def test_host_state_is_a_copy_of_the_moment(tmp_path):
    """What host_state returns does not follow later changes of the CPU
    tensors it was made from (a queued write must write the state of its
    call)."""
    from zeroshotvideoclassification_tpu_torch.train import host_state

    m, opt = _port()
    snap = host_state(TrainState(m, opt, step=3))
    key = "model_state::backbone/stem/bn1/mean"
    before = snap[key].copy()
    with torch.no_grad():
        for v in m.state_dict().values():
            if v.is_floating_point():
                v.add_(1.0)
    np.testing.assert_array_equal(snap[key], before)
    assert snap["__step__"].dtype == np.int32 and int(snap["__step__"]) == 3


def test_profiler_trace_and_step_stats(tmp_path):
    with device_trace(str(tmp_path / "traces")):
        torch.ones(64, 64) @ torch.ones(64, 64)
    traces = os.listdir(tmp_path / "traces")
    assert len(traces) == 1 and traces[0].endswith(".json")
    with open(tmp_path / "traces" / traces[0]) as f:
        assert "traceEvents" in json.load(f)
    stats = StepStats(warmup=1)
    for _ in range(4):
        stats.tick()
    s = stats.summary(items_per_step=8)
    assert s["n"] == 2 and s["items_per_sec"] > 0
