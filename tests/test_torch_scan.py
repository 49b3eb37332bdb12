"""K train steps a dispatch (--steps_per_call) and --debug_nans in the
PyTorch port, on the CPU at small sizes: make_scan_train_step against the
JAX package's scan-fused step (the JAX side through its Pallas BN epilogue
in interpret mode) and against K single steps, the trainer's grouping,
tail and log cadence, --debug_nans grouped and ungrouped, the guard without
it, and the grouped step on two gloo processes against one process. On the
CPU the grouped step runs its steps eagerly, by the same code as on a GPU
apart from the capture and the replays (tests/test_torch_cuda.py holds the
CUDA graphs against eager steps on a GPU). Inputs come from numpy seeds and
weights cross through models/bridge."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zeroshotvideoclassification_tpu.train import (
    TrainState as JaxTrainState,
    make_optimizer as jax_make_optimizer,
)
from zeroshotvideoclassification_tpu.train.step import (
    make_scan_train_step as jax_make_scan_train_step,
)
from zeroshotvideoclassification_tpu_torch.cli import main as port_main
from zeroshotvideoclassification_tpu_torch.config import (
    Config,
    config_from_namespace,
)
from zeroshotvideoclassification_tpu_torch.data.datasets import build_datasets
from zeroshotvideoclassification_tpu_torch.models import bridge, get_network
from zeroshotvideoclassification_tpu_torch.train import (
    make_optimizer,
    make_scan_train_step,
    make_train_step,
    raise_if_not_finite,
    set_lr,
)

from test_torch_parallel import launch
from test_torch_train import (
    assert_trees_close,
    batches,
    interpret_pallas,  # noqa: F401  (a fixture)
    jax_weights,
    port_model,
    seeded_moments,
)
from torch_helpers import remove_large_files, seed_adam

K = 3


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


def stacked(data):
    """[(x, z, labels, weight)] numpy -> [xs, zs, labels, weights] numpy
    with a leading axis of len(data)."""
    return [np.stack([b[i] for b in data]) for i in range(4)]


def jax_scan(model, params, state, data, ce, lr, moments, count):
    """The JAX package's scan-fused step over `data` (one dispatch) from a
    seeded Adam state -> (train state, metrics of [len(data)])."""
    opt = jax_make_optimizer(lr)
    opt_state = opt.init(params)
    guard = opt_state.inner_state
    adam = guard.inner_state[0]._replace(
        count=jnp.asarray(count, jnp.int32),
        mu=jax.tree.map(jnp.asarray, moments[0]),
        nu=jax.tree.map(jnp.asarray, moments[1]))
    opt_state = opt_state._replace(inner_state=guard._replace(
        inner_state=(adam,) + tuple(guard.inner_state[1:])))
    ts = JaxTrainState(params=jax.tree.map(jnp.asarray, params),
                       model_state=jax.tree.map(jnp.asarray, state),
                       opt_state=opt_state, step=jnp.zeros((), jnp.int32))
    step = jax_make_scan_train_step(model, opt, compute_dtype=jnp.float32,
                                    donate=False)
    return step(ts, *stacked(data), ce, jax.random.PRNGKey(0))


def port_scan(params, state, moments=None, count=1000, lr=1e-3,
              steps=K):
    """The port's model from the JAX weights, its guarded Adam (with the
    moments given, or a seeded state) and a scan step of `steps`."""
    m = port_model(params, state)
    opt = make_optimizer(m.parameters(), lr)
    if moments is None:
        seed_adam(opt, m, seed=3, count=count)
    else:
        bridge.adam_from_jax(m, opt, *moments, count)
    return m, opt, make_scan_train_step(m, opt, torch.float32, steps)


def test_scan_step_matches_jax_scan_step(interpret_pallas):
    """K = 3 steps in one dispatch from the same weights and the same
    non-zero Adam state (count 1000) against the JAX package's
    make_scan_train_step, at test_torch_train.test_train_steps_match_jax's
    bars: loss rtol 1e-4, parameters atol 2e-5, Adam's second moment 2e-5
    and first moment 5e-4, BN running statistics 1e-3. The step count and
    Adam's count both advance by K; every step's guard flag is set."""
    model, params, state = jax_weights(seed=2, warm_shape=(4, 1, 8, 32, 32, 3))
    data, ce = batches(K, b=4)
    moments = seeded_moments(params, 5)
    ts, want = jax_scan(model, params, state, data, ce, 1e-3, moments, 1000)
    m, opt, step = port_scan(params, state, moments)
    got = step(*[torch.from_numpy(a) for a in stacked(data)],
               torch.from_numpy(ce))
    assert got["loss"].shape == got["finite"].shape == (K,)
    assert got["finite"].dtype == torch.bool and bool(got["finite"].all())
    np.testing.assert_allclose(got["loss"].numpy(),
                               np.asarray(want["loss"]), rtol=1e-4)
    np.testing.assert_allclose(got["train_accuracy"].numpy(),
                               np.asarray(want["train_accuracy"]))
    got_p, got_s = bridge.to_jax(m.state_dict())
    assert_trees_close(got_p, jax.tree.map(np.asarray, ts.params), atol=2e-5)
    assert_trees_close(got_s, jax.tree.map(np.asarray, ts.model_state),
                       atol=1e-3)
    adam = ts.opt_state.inner_state.inner_state[0]
    mu, nu, count = bridge.adam_to_jax(m, opt)
    assert_trees_close(mu, jax.tree.map(np.asarray, adam.mu), atol=5e-4)
    assert_trees_close(nu, jax.tree.map(np.asarray, adam.nu), atol=2e-5)
    assert step.state.step == int(ts.step) == K
    assert count == int(adam.count) == 1000 + K
    moved = np.abs(bridge.flatten(got_p)["backbone/stem/conv1/w"]
                   - params["backbone"]["stem"]["conv1"]["w"]).max()
    assert moved > 1e-4


def test_scan_step_is_the_single_steps():
    """Two groups of K and a tail of 2 (staged slot by slot, as the trainer
    stages them) against the same 2 K + 2 batches through make_train_step
    from the same state: the same losses, accuracies, flags, parameters,
    BN statistics, moments and counts, bit for bit (on the CPU both are
    the same eager steps)."""
    _, params, state = jax_weights(seed=4)
    data, ce = batches(2 * K + 2, b=2, seed=5)
    ce_t = torch.from_numpy(ce)
    m1, opt1, scan = port_scan(params, state)
    got = []
    for start, n in ((0, K), (K, K), (2 * K, 2)):
        for k in range(n):
            scan.stage(k, *[torch.from_numpy(a) for a in data[start + k]])
        got.append(scan.run(n, ce_t))
    m2 = port_model(params, state)
    opt2 = make_optimizer(m2.parameters(), 1e-3)
    seed_adam(opt2, m2, seed=3, count=1000)
    single = make_train_step(m2, opt2, torch.float32)
    want = [single(*[torch.from_numpy(a) for a in b], ce_t) for b in data]
    for key in ("loss", "train_accuracy", "finite"):
        g = torch.cat([r[key] for r in got])
        assert torch.equal(g, torch.stack([w[key] for w in want])), key
    for k, v in m2.state_dict().items():
        assert torch.equal(m1.state_dict()[k], v), k
    for p1, p2 in zip(m1.parameters(), m2.parameters()):
        for slot in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(opt1.state[p1][slot], opt2.state[p2][slot])
    assert scan.state.step == single.state.step == 2 * K + 2
    assert int(opt1.count) == int(opt2.count) == 1000 + 2 * K + 2


def test_scan_step_takes_the_rate_set_between_calls():
    """set_lr between two groups fills the optimizer's lr tensor in place:
    the second group's update is the one K single steps take at the new
    rate (bit for bit on the CPU), and the tensor object stays the one the
    first group used."""
    _, params, state = jax_weights(seed=4)
    data, ce = batches(2 * K, b=2, seed=6)
    ce_t = torch.from_numpy(ce)
    m1, opt1, scan = port_scan(params, state)
    lr_tensor = opt1.lr_tensors[0]
    scan(*[torch.from_numpy(a) for a in stacked(data[:K])], ce_t)
    set_lr(opt1, 1e-4)
    assert opt1.lr_tensors[0] is lr_tensor and float(lr_tensor) == np.float32(
        1e-4)
    scan(*[torch.from_numpy(a) for a in stacked(data[K:])], ce_t)
    m2 = port_model(params, state)
    opt2 = make_optimizer(m2.parameters(), 1e-3)
    seed_adam(opt2, m2, seed=3, count=1000)
    single = make_train_step(m2, opt2, torch.float32)
    for i, b in enumerate(data):
        if i == K:
            set_lr(opt2, 1e-4)
        single(*[torch.from_numpy(a) for a in b], ce_t)
    for k, v in m2.state_dict().items():
        assert torch.equal(m1.state_dict()[k], v), k


@pytest.mark.parametrize("steps,n", [(1, 1), (K, K + 1), (K, 0)])
def test_scan_step_refuses_what_it_cannot_group(steps, n):
    """A scan of one step is the single step; a group is 1 .. K batches."""
    m = get_network(Config(network="r2plus1d_18", head="mlp"))
    opt = make_optimizer(m.parameters(), 1e-3)
    if steps < 2:
        with pytest.raises(ValueError, match="single step"):
            make_scan_train_step(m, opt, torch.float32, steps)
        return
    scan = make_scan_train_step(m, opt, torch.float32, steps)
    with pytest.raises(ValueError, match=f"{n} batches for a scan of {K}"):
        scan.run(n, torch.zeros(5, 300))


# ------------------------------------------------ the trainer ---------------

def experiment(tmp_path, *flags, log_every=2):
    """cli.main's Experiment on the CPU: r2plus1d_18 at 8x32x32, float32,
    4 training classes of 5 clips (5 steps of 4: an odd tail under
    --steps_per_call 2), logging every `log_every` steps."""
    argv = ["--dataset", "synthetic", "--class_total", "4",
            "--train_samples", "20", "--n_epochs", "1", "--bs", "4",
            "--size", "32", "--clip_len", "8", "--device", "cpu",
            "--compute_dtype", "float32", "--nopretrained",
            "--no-progressbar", "--save_path", str(tmp_path), *flags]
    cfg = config_from_namespace(port_main.build_arg_parser().parse_args(
        argv)).replace(log_every=log_every)
    return port_main.Experiment(cfg, build_datasets(cfg, None),
                                device="cpu")


def logged(exp, tag="Train/Loss"):
    """[(step, value)] of one tag in the run's metrics.jsonl."""
    exp.log.close()
    with open(os.path.join(exp.savename, "metrics.jsonl")) as f:
        rows = [json.loads(ln) for ln in f]
    return [(r["step"], r["value"]) for r in rows if r["tag"] == tag]


def test_trainer_groups_steps_with_an_odd_tail(tmp_path):
    """An epoch of 5 steps at --steps_per_call 2 (two groups and a tail of
    one through the single step) against --steps_per_call 1: the same
    epoch loss and train accuracy, the same 5 steps taken, and the same
    logged steps and values at a log cadence of 2 (logging counts steps,
    not dispatches)."""
    runs = {}
    for k in (2, 1):
        exp = experiment(tmp_path / f"k{k}", "--steps_per_call", str(k))
        assert (exp.scan_step is None) == (k == 1)
        out = exp.train_one_epoch(0)
        runs[k] = (out, exp.train_step.state.step, int(exp.optimizer.count),
                   logged(exp), logged(exp, "Train/RegressorAccuracy"))
    (out2, n2, c2, loss2, acc2), (out1, n1, c1, loss1, acc1) = (runs[2],
                                                                 runs[1])
    assert n2 == n1 == 5 and c2 == c1 == 5
    assert out2["loss"] == out1["loss"] and np.isfinite(out1["loss"])
    assert out2["train_accuracy"] == out1["train_accuracy"]
    assert [s for s, _ in loss2] == [s for s, _ in loss1] == [2, 4]
    assert loss2 == loss1 and acc2 == acc1


def poison(monkeypatch, bad_step):
    """Make the trainer's `bad_step`-th batch of the run NaN."""
    real, seen = port_main.device_batch, [0]

    def batch(*a, **kw):
        out = real(*a, **kw)
        seen[0] += 1
        if seen[0] == bad_step:
            out["x"] = torch.full_like(out["x"], float("nan"))
        return out

    monkeypatch.setattr(port_main, "device_batch", batch)


@pytest.mark.parametrize("k,bad", [(1, 2), (2, 3), (2, 5)])
def test_debug_nans_names_the_step(tmp_path, monkeypatch, k, bad):
    """--debug_nans: a NaN batch raises FloatingPointError naming its
    global step, single, inside a group and in the tail; on the CPU the
    step runs under autograd's anomaly mode, so the error also names the
    backward op that returned NaN. The guard skipped the update: Adam's
    count is the steps before it."""
    exp = experiment(tmp_path, "--steps_per_call", str(k), "--debug_nans")
    poison(monkeypatch, bad)
    with pytest.raises(FloatingPointError,
                       match=rf"step {bad} is not finite.*nan values"):
        exp.train_one_epoch(0)
    assert int(exp.optimizer.count) == bad - 1
    assert exp.train_step.state.step == bad - 1


@pytest.mark.parametrize("k", [1, 2])
def test_without_debug_nans_the_guard_skips(tmp_path, monkeypatch, k):
    """Without --debug_nans the epoch goes on past a NaN batch: the guard
    skips that step on the device, and every later one (the NaN batch also
    poisoned the BN running statistics, as in the JAX package), and
    nothing is read on the host."""
    exp = experiment(tmp_path, "--steps_per_call", str(k))
    poison(monkeypatch, 3)
    out = exp.train_one_epoch(0)
    assert not np.isfinite(out["loss"])
    assert exp.train_step.state.step == 5
    assert int(exp.optimizer.count) == 2
    assert int(exp.optimizer.total_notfinite) == 3


@pytest.mark.parametrize("finite,loss,first,want", [
    ([True, True], [0.1, 0.2], 7, None),
    ([True, False], [0.1, 0.2], 7, "step 8 is not finite"),
    ([True, True, True], [0.1, float("inf"), float("nan")], 1,
     "step 2 is not finite"),
    ([False], [float("nan")], 12, "step 12 is not finite")])
def test_raise_if_not_finite(finite, loss, first, want):
    """--debug_nans's host check of one dispatch: the first step whose guard
    flag is off or whose loss is not finite, by its global number."""
    metrics = {"finite": torch.tensor(finite),
               "loss": torch.tensor(loss, dtype=torch.float32)}
    if want is None:
        raise_if_not_finite(metrics, first)
    else:
        with pytest.raises(FloatingPointError, match=want):
            raise_if_not_finite(metrics, first)


# ------------------------------------------------ two processes -------------

def test_scan_step_on_two_gloo_processes(tmp_path):
    """make_scan_train_step(steps=2) on 2 gloo processes of 2 clips each
    (one group and a tail of one; rank 1's shard carries a weight-0 row)
    against one process on the 4-clip batches: loss rtol 1e-4, parameters
    atol 2e-5; losses, parameters and BN statistics bit-equal across the
    processes."""
    arch = "r3d_18"
    _, params, state = jax_weights(arch, seed=2,
                                   warm_shape=(4, 1, 2, 32, 32, 3))
    rng = np.random.default_rng(3)
    ce = rng.normal(size=(5, 300)).astype(np.float32)
    ce /= np.linalg.norm(ce, axis=1, keepdims=True)
    data = []
    for _ in range(3):
        labels = rng.integers(0, 5, 4).astype(np.int32)
        x = rng.uniform(-0.5, 0, (4, 1, 2, 32, 32, 3)).astype(np.float32)
        data.append((x, ce[labels], labels,
                     np.asarray([1, 1, 1, 0], np.float32)))
    m = port_model(params, state, arch)
    opt = make_optimizer(m.parameters(), 1e-3)
    seed_adam(opt, m, seed=3, count=1000)
    scan = make_scan_train_step(m, opt, torch.float32, 2)
    ce_t = torch.from_numpy(ce)
    one = [scan(*[torch.from_numpy(a) for a in stacked(data[:2])], ce_t),
           scan(*[torch.from_numpy(a) for a in stacked(data[2:])], ce_t)]
    one_loss = torch.cat([r["loss"] for r in one]).numpy()
    inp = tmp_path / "scan.pt"
    torch.save({"arch": arch, "lr": 1e-3, "adam_seed": 3,
                "adam_count": 1000, "steps": 2,
                "state_dict": bridge.from_jax(params, state),
                "class_embed": ce_t,
                "batches": [[torch.from_numpy(a) for a in b] for b in data]},
               inp)
    outs, _ = launch(tmp_path, "scan", 2, inp)
    r0, r1 = (torch.load(o, weights_only=True) for o in outs)
    for f in (inp, *outs):
        f.unlink()
    assert torch.equal(r0["loss"], r1["loss"])
    assert r0["step"] == r1["step"] == 3
    assert r0["count"] == r1["count"] == 1003
    for k in r0["state_dict"]:
        assert torch.equal(r0["state_dict"][k], r1["state_dict"][k]), k
    np.testing.assert_allclose(r0["loss"].numpy(), one_loss, rtol=1e-4)
    for k, v in m.state_dict().items():
        if "running" in k or "tracked" in k:
            continue
        np.testing.assert_allclose(r0["state_dict"][k].numpy(), v.numpy(),
                                   atol=2e-5, err_msg=k)
