"""The head's tensor parallelism of the PyTorch port (--tp), on the CPU
under gloo: the grid against the JAX package's make_mesh, shard_head and
its inverse, the model-group collectives, two float32 steps on grids of 1
x 2 and 2 x 2 processes against one process and against the JAX package's
step under state_shardings on the same mesh, and on a grid of 4 x 2 (8
processes) alike, the guard's agreement, a NaN batch, dropout across a
model group, BN's running statistics made one before an evaluation and a
checkpoint, the width check, and the trainer at --tp 2 against --tp 1
with its checkpoint loaded by both packages. The processes are
tests/torch_parallel_worker.py's (modes tp, tp_epoch, tp_bn and cli); the
sizes are tests/test_torch_parallel.py's: r3d_18, 2 frames of 32x32, 8
clips a global batch, float32."""

import copy
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zeroshotvideoclassification_tpu.parallel import (
    make_mesh as jax_make_mesh,
    replicated as jax_replicated,
    shard_batch as jax_shard_batch,
    state_shardings as jax_state_shardings,
)
from zeroshotvideoclassification_tpu.train import (
    TrainState as JaxTrainState,
    make_optimizer as jax_make_optimizer,
)
from zeroshotvideoclassification_tpu.train.checkpoint import (
    load_checkpoint as jax_load_checkpoint,
    save_checkpoint as jax_save_checkpoint,
)
from zeroshotvideoclassification_tpu.train.step import (
    make_train_step as jax_make_train_step,
)
from zeroshotvideoclassification_tpu_torch.cli import main as port_main
from zeroshotvideoclassification_tpu_torch.config import Config
from zeroshotvideoclassification_tpu_torch.models import bridge, get_network
from zeroshotvideoclassification_tpu_torch.models.heads import (
    MLP,
    check_tensor_parallel,
)
from zeroshotvideoclassification_tpu_torch.models.layers import init_weights
from zeroshotvideoclassification_tpu_torch.parallel import grid_layout
from zeroshotvideoclassification_tpu_torch.train import (
    load_checkpoint,
    make_optimizer,
    make_train_step,
    read_checkpoint,
)

from test_torch_parallel import ARCH, SMALL, launch
from test_torch_train import jax_weights, port_model
from torch_helpers import remove_large_files, seed_adam

HEAD = "output2emb_proj.layers"


@pytest.fixture(autouse=True)
def grad_enabled():
    """Another test module switches autograd off for its whole process when
    it is imported; the tests here differentiate."""
    with torch.enable_grad():
        yield


@pytest.fixture(autouse=True)
def drop_large_files(tmp_path):
    """Delete the test's checkpoints, tensor files and the workers' outputs
    when it ends (torch_helpers.remove_large_files)."""
    yield
    remove_large_files(tmp_path)


# ------------------------------------------------------- the grid -----------

@pytest.mark.parametrize("dp,tp", [(1, 2), (2, 2), (4, 2), (2, 4), (1, 4),
                                   (1, 8), (8, 1), (2, 1)])
def test_grid_layout_matches_the_jax_mesh(dp, tp):
    """Rank r sits where device r sits in the JAX package's
    make_mesh((dp, tp), ('data', 'model')) over the 8 virtual devices: the
    data groups are the mesh's columns, the model groups its rows."""
    mesh = jax_make_mesh((dp, tp), ("data", "model"),
                         devices=jax.devices()[:dp * tp])
    ids = np.vectorize(lambda d: d.id)(mesh.devices)
    data, model = grid_layout(dp * tp, tp)
    assert data == [list(ids[:, m]) for m in range(tp)]
    assert model == [list(ids[d, :]) for d in range(dp)]


@pytest.mark.parametrize("world,tp", [(8, 3), (2, 4), (6, 4), (1, 2)])
def test_grid_layout_refuses_what_make_mesh_refuses(world, tp):
    with pytest.raises(ValueError) as want:
        jax_make_mesh((-1, tp), ("data", "model"),
                      devices=jax.devices()[:world])
    with pytest.raises(ValueError) as got:
        grid_layout(world, tp)
    assert str(got.value) == str(want.value)


def test_a_width_that_tp_does_not_divide_raises_like_jax():
    """tp 3 over 6 devices: the JAX package's device_put of the mlp head
    under state_shardings raises ValueError (fc1's 512 columns do not
    split three ways), and the port's check and MLP.shard raise
    ValueError; the linear and C3D heads are replicated in both and take
    any tp."""
    mesh = jax_make_mesh((2, 3), ("data", "model"),
                         devices=jax.devices()[:6])
    tree = {"head": {"fc1": {"w": np.zeros((512, 512), np.float32),
                             "b": np.zeros(512, np.float32)}}}
    with pytest.raises(ValueError):
        jax.device_put(tree, jax_state_shardings(tree, mesh))
    linear = {"head": {"regressor": {"w": np.zeros((512, 300), np.float32)}}}
    jax.device_put(linear, jax_state_shardings(linear, mesh))
    with pytest.raises(ValueError, match="does not divide"):
        check_tensor_parallel(Config(network="r2plus1d_18"), 3)
    with pytest.raises(ValueError, match="does not divide"):
        MLP().shard(3, 0)
    for cfg in (Config(network="r2plus1d_18", head="linear"),
                Config(network="resnet18"), Config(network="c3d")):
        check_tensor_parallel(cfg, 3)
    check_tensor_parallel(Config(network="r2plus1d_18"), 4)


def test_the_trainer_refuses_a_bad_tp_before_the_datasets(tmp_path,
                                                          monkeypatch):
    """--tp 3 (the width) and --tp 2 on one process (the mesh) raise
    ValueError before any dataset is built."""
    def no_datasets(*a, **kw):
        raise AssertionError("datasets built before the refusal")

    monkeypatch.setattr(port_main, "build_datasets", no_datasets)
    base = ["--dataset", "synthetic", "--device", "cpu", "--save_path",
            str(tmp_path)]
    with pytest.raises(ValueError, match="does not divide"):
        port_main.main(base + ["--tp", "3"])
    with pytest.raises(ValueError, match="does not divide the 1 available"):
        port_main.main(base + ["--tp", "2"])


# ------------------------------------------------------- shard_head ---------

@pytest.fixture(scope="module")
def weights():
    """r3d_18 + mlp: the JAX package's (params, model_state) and the port's
    model of them."""
    _, params, state = jax_weights(ARCH, seed=7,
                                   warm_shape=(2, 1, 2, 32, 32, 3))
    return params, state, port_model(params, state, ARCH)


@pytest.mark.parametrize("tp", [2, 4, 8])
def test_shard_head_round_trips_bit_for_bit(weights, tp):
    """A whole JAX tree through from_jax and shard_head: each shard is what
    ZeroShotModel.shard_head keeps of the same whole model, and
    unshard_head of the tp shards gives the whole state dict back bit for
    bit; fc2's bias and the backbone are whole on every shard."""
    params, state, whole_model = weights
    whole = bridge.from_jax(params, state)
    shards = [bridge.shard_head(whole, tp, m) for m in range(tp)]
    back = bridge.unshard_head(shards)
    assert back.keys() == whole.keys()
    for k in whole:
        assert torch.equal(back[k], whole[k]), k
    f = whole[f"{HEAD}.0.weight"].shape[0]
    for m, sd in enumerate(shards):
        assert sd[f"{HEAD}.0.weight"].shape == (f // tp, f)
        assert sd[f"{HEAD}.0.bias"].shape == (f // tp,)
        assert sd[f"{HEAD}.1.weight"].shape == (300, f // tp)
        assert torch.equal(sd[f"{HEAD}.1.bias"], whole[f"{HEAD}.1.bias"])
        model = copy.deepcopy(whole_model).shard_head(tp, m)
        assert model.tp == (tp, m)
        got = model.state_dict()
        assert got.keys() == sd.keys()
        for k in sd:
            assert torch.equal(got[k], sd[k]), k


def test_adam_moments_shard_and_gather_back_bit_for_bit(weights):
    """adam_from_jax gives a sharded model's optimizer its shard of whole
    JAX moments; the shards' moments, made whole by unshard_head, are the
    whole moments bit for bit (adam_to_jax of them equals the trees)."""
    _, _, m = weights
    opt = make_optimizer(m.parameters(), 1e-3)
    seed_adam(opt, m, seed=9, count=17)
    mu, nu, count = bridge.adam_to_jax(m, opt)
    mu, nu = (jax.tree.map(np.array, t) for t in (mu, nu))
    tp = 2
    per = {"exp_avg": [], "exp_avg_sq": []}
    for i in range(tp):
        mi = copy.deepcopy(m).shard_head(tp, i)
        oi = make_optimizer(mi.parameters(), 1e-3)
        bridge.adam_from_jax(mi, oi, mu, nu, count)
        assert int(oi.count) == count
        for slot in per:
            per[slot].append({k: oi.state[p][slot]
                              for k, p in mi.named_parameters()})
    for slot, tree in (("exp_avg", mu), ("exp_avg_sq", nu)):
        whole = bridge.unshard_head(per[slot])
        want = {k: opt.state[p][slot] for k, p in m.named_parameters()}
        for k in want:
            assert torch.equal(whole[k], want[k]), (slot, k)
        got = bridge.flatten(bridge.to_jax(whole)[0])
        for k, v in bridge.flatten(tree).items():
            np.testing.assert_array_equal(got[k], v, err_msg=k)


# ------------------------------------------- 1 x 2, 2 x 2 and 4 x 2 steps --

def jax_sharded_steps(model, params, state, data, ce, lr, mu, nu, count,
                      dp, tp):
    """The JAX package's make_train_step over a (dp, tp) mesh of the
    virtual devices, its state placed by state_shardings (the mlp head's
    fc1 / fc2 and their moments sharded on 'model') and each batch sharded
    on 'data', from the same Adam state. -> (state, [(loss, acc)])."""
    mesh = jax_make_mesh((dp, tp), ("data", "model"),
                         devices=jax.devices()[:dp * tp])
    opt = jax_make_optimizer(lr)
    opt_state = opt.init(params)
    guard = opt_state.inner_state
    adam = guard.inner_state[0]._replace(
        count=jnp.asarray(count, jnp.int32),
        mu=jax.tree.map(jnp.asarray, mu), nu=jax.tree.map(jnp.asarray, nu))
    opt_state = opt_state._replace(inner_state=guard._replace(
        inner_state=(adam,) + tuple(guard.inner_state[1:])))
    ts = JaxTrainState(params=jax.tree.map(jnp.asarray, params),
                       model_state=jax.tree.map(jnp.asarray, state),
                       opt_state=opt_state, step=jnp.zeros((), jnp.int32))
    ts = jax.device_put(ts, jax_state_shardings(ts, mesh))
    assert "model" in str(ts.params["head"]["fc1"]["w"].sharding.spec)
    step = jax_make_train_step(model, opt, compute_dtype=jnp.float32,
                               donate=False)
    ce = jax.device_put(ce, jax_replicated(mesh))
    out = []
    for batch in data:
        ts, m = step(ts, *jax_shard_batch(mesh, batch), ce,
                     jax.random.PRNGKey(0))
        out.append((float(m["loss"]), float(m["train_accuracy"])))
    return ts, out


@pytest.fixture(scope="module")
def tp_runs(tmp_path_factory):
    """Two float32 steps of r3d_18 on global batches of 8 clips (weights
    1 x 6, 0 x 2: the two data shards of 2 x 2 sum 4 and 2, the four of
    4 x 2 sum 2, 2, 2 and 0) from one seeded Adam state: one port process on
    the whole batches, and 2 processes as 1 x 2, 4 as 2 x 2 and 8 as 4 x 2
    (mode tp), and the JAX step on each mesh shape."""
    tmp = tmp_path_factory.mktemp("tp")
    rng = np.random.default_rng(10)
    with torch.enable_grad():
        model, params, state = jax_weights(ARCH, seed=11,
                                           warm_shape=(8, 1, 2, 32, 32, 3))
        ce = rng.normal(size=(5, 300)).astype(np.float32)
        ce /= np.linalg.norm(ce, axis=1, keepdims=True)
        data = []
        for _ in range(2):
            labels = rng.integers(0, 5, 8).astype(np.int32)
            xb = rng.uniform(-0.5, 0, (8, 1, 2, 32, 32, 3)).astype(np.float32)
            w = np.asarray([1, 1, 1, 1, 1, 1, 0, 0], np.float32)
            data.append((xb, ce[labels], labels, w))
        m = port_model(params, state, ARCH)
        opt = make_optimizer(m.parameters(), 1e-3)
        seed_adam(opt, m, seed=12, count=1000)
        mu, nu, count = bridge.adam_to_jax(m, opt)
        mu, nu = (jax.tree.map(np.array, t) for t in (mu, nu))
        step = make_train_step(m, opt, compute_dtype=torch.float32)
        one = []
        for xb, z, labels, w in data:
            r = step(*[torch.from_numpy(a) for a in (xb, z, labels, w, ce)])
            one.append((float(r["loss"]), float(r["train_accuracy"])))
    out = {"one": one, "one_model": m, "init": params}
    for dp, tp in ((1, 2), (2, 2), (4, 2)):
        ts, jm = jax_sharded_steps(model, params, state, data, ce, 1e-3, mu,
                                   nu, count, dp, tp)
        inp = tmp / f"tp_{dp}x{tp}.pt"
        torch.save({"tp": tp, "step": {
            "arch": ARCH, "lr": 1e-3, "count": count,
            "mu": jax.tree.map(torch.from_numpy, mu),
            "nu": jax.tree.map(torch.from_numpy, nu),
            "state_dict": bridge.from_jax(params, state),
            "class_embed": torch.from_numpy(ce),
            "batches": [[torch.from_numpy(a) for a in b] for b in data]}},
            inp)
        outs, _ = launch(tmp, "tp", dp * tp, inp,
                         store=str(tmp / f"tp_{dp}x{tp}_store"))
        ranks = [torch.load(o, weights_only=True) for o in outs]
        for f in (inp, *outs):
            f.unlink()
        out[(dp, tp)] = {"ranks": ranks, "jax": jm, "jax_ts": ts}
    return out


@pytest.mark.parametrize("dp,tp", [(1, 2), (2, 2), (4, 2)])
def test_grid_collectives(tp_runs, dp, tp):
    """Each process's place on the grid; gather_model concatenates the
    model group's tensors in model-index order, gather_rows the data
    shards' rows in data-index order (once each: a model group shares its
    rows); agree_finite is False on every process where one is False;
    reduce_from_model sums forward and passes the gradient through, and
    copy_to_model sums it over the model group, so the input's gradient is
    that of the replicated loss."""
    ranks = tp_runs[(dp, tp)]["ranks"]
    for r, res in enumerate(ranks):
        d, m = divmod(r, tp)
        assert res["grid"] == [dp, tp, d, m]
        want = torch.cat([torch.arange(6.0).reshape(2, 3) + 10 * (d * tp + j)
                          for j in range(tp)], dim=1)
        assert torch.equal(res["gather_model"], want)
        want = torch.cat([torch.arange(6.0).reshape(2, 3) + 10 * j
                          for j in range(dp)])
        assert torch.equal(res["gather_rows"], want)
        in_group_1 = 1 in range(d * tp, d * tp + tp)
        assert res["agreed"] == [not in_group_1, True]
        total = tp * (tp + 1) / 2
        assert torch.equal(res["reduced"], torch.full((3,), total))
        assert torch.equal(res["copy_grad"], torch.full((3,), total))


@pytest.mark.parametrize("dp,tp", [(1, 2), (2, 2), (4, 2)])
def test_sharded_steps_match_one_process_and_jax(tp_runs, dp, tp):
    """Two float32 steps on a grid of dp x tp processes: every process
    reports the global loss and accuracy, within rtol 1e-4 of one port
    process on the whole batches and of the JAX package's step on the same
    mesh; the head's shards, made whole, and every other parameter within
    atol 2e-5 of both; the backbone and fc2's bias bit-equal on every
    process, each shard bit-equal on the processes that hold it, Adam's
    count equal."""
    run = tp_runs[(dp, tp)]
    steps = [r["step"] for r in run["ranks"]]
    for s in steps:
        assert s["metrics"] == steps[0]["metrics"]
        assert s["count"] == 1002
    for k, v in steps[0]["state_dict"].items():
        for r, s in enumerate(steps):
            if k in bridge.TP_AXES:
                same = steps[r % tp]["state_dict"][k]
                assert torch.equal(s["state_dict"][k], same), (r, k)
            else:
                assert torch.equal(s["state_dict"][k], v), (r, k)
    got = np.asarray(steps[0]["metrics"])
    for ref in (tp_runs["one"], run["jax"]):
        np.testing.assert_allclose(got[:, 0], np.asarray(ref)[:, 0],
                                   rtol=1e-4)
        np.testing.assert_allclose(got[:, 1], np.asarray(ref)[:, 1])
    whole = bridge.unshard_head([s["state_dict"] for s in steps[:tp]])
    assert whole[f"{HEAD}.0.weight"].shape == (512, 512)
    one = tp_runs["one_model"].state_dict()
    for k, v in whole.items():
        if "running" in k or "tracked" in k:
            continue
        np.testing.assert_allclose(v.numpy(), one[k].numpy(), atol=2e-5,
                                   err_msg=k)
    got_p, _ = bridge.to_jax(whole)
    want_p = bridge.flatten(jax.tree.map(np.asarray, run["jax_ts"].params))
    for k, v in bridge.flatten(got_p).items():
        np.testing.assert_allclose(v, want_p[k], atol=2e-5, err_msg=k)
    moved = np.abs(bridge.flatten(got_p)["head/fc1/w"]
                   - tp_runs["init"]["head"]["fc1"]["w"])
    assert moved.max() > 1e-4


@pytest.mark.parametrize("dp,tp", [(1, 2), (2, 2), (4, 2)])
def test_a_non_finite_shard_or_batch_changes_nothing(tp_runs, dp, tp):
    """A NaN in the fc1 gradient of the processes at model index 1 only:
    every process skips the step (the flag is agreed over the model
    group). A NaN in the last process's batch: every process skips that
    step. Parameters, moments and Adam's count bit-equal on every
    process."""
    for r in tp_runs[(dp, tp)]["ranks"]:
        assert r["guard"] == {"finite": False, "unchanged": True}
        assert r["nan"] == {"finite": False, "unchanged": True}


# ------------------------------------------------ dropout across a group ----

def test_linear_head_dropout_is_equal_across_a_model_group(tmp_path):
    """--network resnet18 (R3D-18 + the linear head, dropout 0.05) at --tp
    2 on 2 processes: one epoch of 2 steps; the generator is seeded with
    the data index (0 on both: (seed << 16) + epoch), so both members draw
    the same masks and end bit-equal. The masks are at work: the same
    epoch on one process without dropout ends elsewhere."""
    argv = SMALL + ["--class_total", "4", "--train_samples", "8", "--bs",
                    "4", "--device", "cpu", "--network", "resnet18",
                    "--save_path", str(tmp_path / "runs")]
    inp = tmp_path / "epoch.json"
    inp.write_text(json.dumps(argv + ["--tp", "2"]))
    outs, _ = launch(tmp_path, "tp_epoch", 2, inp)
    r0, r1 = (torch.load(o, weights_only=True) for o in outs)
    assert r0["grid"] == [1, 2, 0, 0] and r1["grid"] == [1, 2, 0, 1]
    assert r0["seed"] == r1["seed"] == 1 << 16
    assert r0["summary"]["loss"] == r1["summary"]["loss"]
    for k, v in r0["state_dict"].items():
        assert torch.equal(v, r1["state_dict"][k]), k
    cfg = port_main.config_from_namespace(
        port_main.build_arg_parser().parse_args(argv))
    exp = port_main.Experiment(cfg, port_main.build_datasets(cfg, None),
                               device="cpu")
    assert exp.model.dropout_rate == 0.05
    exp.model.dropout_rate = 0.0
    plain = exp.train_one_epoch(0)["loss"]
    exp.log.close()
    assert plain != r0["summary"]["loss"]


# ------------------------------------------ BN statistics across a group ----

def test_a_model_group_evaluates_and_saves_one_set_of_bn_statistics(
        tmp_path):
    """cli.main's Experiment.run at --tp 2 on 2 processes (one epoch of 2
    steps, the evaluation, --checkpoint_every 1), where after the steps
    the member at model index 1 shifts its BN running statistics by a
    relative 2^-20, as a GPU's cuDNN may round that member's forward:
    before the evaluation and before the checkpoint both members make one
    broadcast of every running mean and variance from model index 0 over
    their model group, in the same order, so they end bit-equal, at
    process 0's values, with one summary (losses and accuracies)."""
    argv = SMALL + ["--class_total", "4", "--train_samples", "16", "--bs",
                    "8", "--n_epochs", "1", "--checkpoint_every", "1",
                    "--device", "cpu", "--tp", "2",
                    "--save_path", str(tmp_path / "runs")]
    inp = tmp_path / "bn.json"
    inp.write_text(json.dumps(argv))
    outs, _ = launch(tmp_path, "tp_bn", 2, inp)
    r0, r1 = (torch.load(o, weights_only=True) for o in outs)
    assert r0["grid"] == [1, 2, 0, 0] and r1["grid"] == [1, 2, 0, 1]
    for a, b in zip(r0["stats"], r1["stats"]):
        assert torch.equal(a, b)
    numel = sum(t.numel() for t in r0["stats"])
    want = [{"src": 0, "numel": numel, "group": [0, 1]}] * 2
    assert r0["broadcasts"] == r1["broadcasts"] == want
    for k in ("loss", "train_accuracy", "synthetic_test_accuracy",
              "best_accuracy"):
        assert r0["summary"][k] == r1["summary"][k], k


# ------------------------------------------------ the trainer ---------------

def test_trainer_at_tp2_matches_tp1_and_its_checkpoint_loads_in_both(
        tmp_path):
    """cli.main at --tp 2 on 2 processes against one process at --tp 1,
    both resuming one JAX checkpoint (a seeded Adam state, whole head:
    a --tp 1 checkpoint resumed at --tp 2) for one epoch of 2 steps of 8
    clips and the evaluation: loss and train accuracy rtol 1e-4, the test
    accuracy equal, the last.npz parameters atol 2e-5. The --tp 2 run's
    last.npz holds the head whole and loads strictly in the JAX package
    and in the port at --tp 1; process 1 writes nothing."""
    model, params, state = jax_weights(ARCH, seed=13,
                                       warm_shape=(8, 1, 2, 32, 32, 3))
    m = port_model(params, state, ARCH)
    opt = make_optimizer(m.parameters(), 1e-3)
    seed_adam(opt, m, seed=14, count=1000)
    mu, nu, count = bridge.adam_to_jax(m, opt)
    jopt = jax_make_optimizer(1e-3)
    opt_state = jopt.init(params)
    guard = opt_state.inner_state
    adam = guard.inner_state[0]._replace(
        count=jnp.asarray(count, jnp.int32),
        mu=jax.tree.map(jnp.asarray, mu), nu=jax.tree.map(jnp.asarray, nu))
    opt_state = opt_state._replace(inner_state=guard._replace(
        inner_state=(adam,) + tuple(guard.inner_state[1:])))
    ts = JaxTrainState(params, state, opt_state, jnp.zeros((), jnp.int32))
    args = SMALL + ["--class_total", "4", "--train_samples", "16", "--bs",
                    "8", "--n_epochs", "1", "--checkpoint_every", "1",
                    "--device", "cpu"]
    out = {}
    for tp in (1, 2):
        ckpt = str(tmp_path / f"tp{tp}" / "runs" / "run" / "last.npz")
        jax_save_checkpoint(ckpt, ts, epoch=-1, accuracy=0.0)
        argv = args + ["--resume", ckpt, "--save_path",
                       str(tmp_path / f"tp{tp}" / "runs")]
        if tp == 1:
            summary = port_main.main(argv)
        else:
            inp = tmp_path / "cli.json"
            inp.write_text(json.dumps(argv + ["--tp", "2"]))
            outs, logs = launch(tmp_path, "cli", 2, inp)
            r0, r1 = (json.loads(o.read_text()) for o in outs)
            assert r1["writes"] == [], r1["writes"]
            assert any(w.endswith("last.npz") for w in r0["writes"])
            for k in ("loss", "train_accuracy", "synthetic_test_accuracy"):
                assert r0["summary"][k] == r1["summary"][k], k
            summary = r0["summary"]
        out[tp] = (summary, ckpt)
    (s1, c1), (s2, c2) = out[1], out[2]
    for k in ("loss", "train_accuracy"):
        np.testing.assert_allclose(s2[k], s1[k], rtol=1e-4, err_msg=k)
    assert s2["synthetic_test_accuracy"] == s1["synthetic_test_accuracy"]
    p1, p2 = read_checkpoint(c1)[0], read_checkpoint(c2)[0]
    assert p1.keys() == p2.keys()
    assert p2["head/fc1/w"].shape == (512, 512)
    for k in p1:
        np.testing.assert_allclose(p2[k], p1[k], atol=2e-5, err_msg=k)
    # the JAX package loads it strictly, every section
    loaded, meta = jax_load_checkpoint(c2, ts)
    assert meta["epoch"] == 0
    got = bridge.flatten(jax.tree.map(np.asarray, loaded.params))
    for k, v in p2.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    # the port at --tp 1, strictly, optimizer state and all
    whole = get_network(Config(network=ARCH, head="mlp"))
    init_weights(whole, torch.Generator().manual_seed(0))
    meta = load_checkpoint(c2, whole, make_optimizer(whole.parameters()))
    assert meta["epoch"] == 0 and meta["step"] == 2
