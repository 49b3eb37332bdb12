"""Data parallelism of the PyTorch port across processes (parallel/), on the
CPU under gloo: make_mesh and shard_table against the JAX package's;
synchronised BN, the train step with unequal weight sums, the evaluation
over a ragged table and the trainer, each on real OS processes
(tests/torch_parallel_worker.py, joined through a file store in tmp_path)
against one process on the whole batch and against the JAX package. The
sizes are tests/multihost_worker.py's: r3d_18, --size 32, --clip_len 2,
float32, a few samples."""

import json
import os
import socket
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zeroshotvideoclassification_tpu.config import Config as JaxConfig
from zeroshotvideoclassification_tpu.data.datasets import (
    build_datasets as jax_build_datasets,
)
from zeroshotvideoclassification_tpu.parallel import (
    make_mesh as jax_make_mesh,
    shard_table as jax_shard_table,
)
from zeroshotvideoclassification_tpu.train import (
    TrainState as JaxTrainState,
    make_optimizer as jax_make_optimizer,
)
from zeroshotvideoclassification_tpu.train.checkpoint import (
    save_checkpoint as jax_save_checkpoint,
)
from zeroshotvideoclassification_tpu_torch.cli import main as port_main
from zeroshotvideoclassification_tpu_torch.config import Config
from zeroshotvideoclassification_tpu_torch.data.datasets import build_datasets
from zeroshotvideoclassification_tpu_torch.models import bridge, get_network
from zeroshotvideoclassification_tpu_torch.models import layers as PL
from zeroshotvideoclassification_tpu_torch.models.layers import init_weights
from zeroshotvideoclassification_tpu_torch.parallel import (
    make_mesh,
    maybe_initialize,
    multihost,
    shard_table,
)
from zeroshotvideoclassification_tpu_torch.train import (
    make_optimizer,
    make_train_step,
    read_checkpoint,
    read_meta,
)

from test_torch_train import jax_steps, jax_weights, port_model
from torch_helpers import calibrate_bn, seed_adam

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(ROOT, "tests", "torch_parallel_worker.py")
LAUNCH_TIMEOUT = 120  # seconds for every launch; the children are killed
ARCH = "r3d_18"
SMALL = ["--dataset", "synthetic", "--clip_len", "2", "--size", "32",
         "--network", ARCH, "--compute_dtype", "float32", "--seed", "1",
         "--nopretrained", "--no-progressbar"]


@pytest.fixture(autouse=True)
def grad_enabled():
    """Another test module switches autograd off for its whole process when
    it is imported; the tests here differentiate."""
    with torch.enable_grad():
        yield


@pytest.fixture(autouse=True)
def drop_large_files(tmp_path):
    """Delete the test's checkpoints and tensor files when it ends: r3d_18's
    npz files are ~400 MB each."""
    yield
    for pattern in ("*.npz", "*.pt"):
        for f in tmp_path.rglob(pattern):
            f.unlink()


def launch(tmp, mode, world, inp, store=None):
    """Run `world` worker processes of `mode` and wait for all of them, at
    most LAUNCH_TIMEOUT seconds in all; -> (their output paths, logs)."""
    store = store or str(tmp / f"{mode}_store")
    outs = [tmp / f"{mode}_{r}.out" for r in range(world)]
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="2")
    procs = [subprocess.Popen(
        [sys.executable, WORKER, mode, str(world), str(r), store, str(inp),
         str(outs[r])], cwd=ROOT, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT) for r in range(world)]
    deadline = time.monotonic() + LAUNCH_TIMEOUT
    logs = []
    try:
        for p in procs:
            left = max(deadline - time.monotonic(), 1.0)
            logs.append(p.communicate(timeout=left)[0].decode())
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r}:\n{log[-6000:]}"
    return outs, logs


# ------------------------------------------------------- make_mesh ----------

SHAPES = [((-1,), ("data",)), ((2,), ("data",)), ((4,), ("data",)),
          ((3,), ("data",)), ((-1, 1), ("data", "model")),
          ((-1, 2), ("data", "model")), ((2, -1), ("data", "model")),
          ((-1, 3), ("data", "model")), ((-1, -1), ("data", "model")),
          ((1, -1), ("data", "model")), ((2, 2), ("data", "model")),
          ((0, -1), ("data", "model"))]


@pytest.mark.parametrize("n", [1, 2, 4, 8])
@pytest.mark.parametrize("shape,axes", SHAPES)
def test_make_mesh_matches_jax(shape, axes, n):
    """The same shapes fail with the same message and the same shapes give
    the same axis sizes, a 'model' axis above 1 (--tp) too."""
    try:
        want = jax_make_mesh(shape, axes, devices=jax.devices()[:n])
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            make_mesh(shape, axes, n)
        assert str(got.value) == str(e)
        return
    assert make_mesh(shape, axes, n) == dict(zip(axes, want.devices.shape))


def test_make_mesh_defaults_to_the_group():
    assert make_mesh() == {"data": 1}  # no group: one process


# ------------------------------------------------------- shard_table --------

@pytest.mark.parametrize("which,pc", [("testing", 4), ("testing", 3),
                                      ("training", 5), ("training", 2)])
def test_shard_table_matches_jax(monkeypatch, which, pc):
    """Every process's shard of an even table (10 training rows over 5 or 2
    processes) and of a ragged one (15 test rows over 4 processes: 4 + 4 +
    4 + 3 and a pad labelled -1) has the JAX package's fnames and
    labels."""
    kw = dict(dataset="synthetic", class_total=10, train_samples=16, bs=4)
    table = build_datasets(Config(**kw), None)[which][0]
    jtable = jax_build_datasets(JaxConfig(**kw), None)[which][0]
    assert len(table) == len(jtable) == {"testing": 15, "training": 10}[which]
    for pi in range(pc):
        monkeypatch.setattr(jax, "process_count", lambda: pc)
        monkeypatch.setattr(jax, "process_index", lambda: pi)
        monkeypatch.setattr(multihost, "process_count", lambda: pc)
        monkeypatch.setattr(multihost, "process_index", lambda: pi)
        got, want = shard_table(table), jax_shard_table(jtable)
        assert len(got) == len(want) == -(-len(table) // pc)
        assert [tuple(f) for f in got.fnames] == [tuple(f)
                                                  for f in want.fnames]
        np.testing.assert_array_equal(got.label_idx, want.label_idx)
        assert got.label_idx.dtype == np.int32
    monkeypatch.setattr(multihost, "process_count", lambda: 1)
    assert shard_table(table) is table


# ------------------------------------------------------- plain checks -------

def test_maybe_initialize_is_a_no_op_without_hints(monkeypatch):
    for k in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR"):
        monkeypatch.delenv(k, raising=False)
    assert maybe_initialize() is False
    assert maybe_initialize(device="cpu") is False
    assert not torch.distributed.is_initialized()
    assert multihost.process_count() == 1 and multihost.process_index() == 0
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    with pytest.raises(ValueError, match="WORLD_SIZE"):
        maybe_initialize()
    assert not torch.distributed.is_initialized()


class _Built(Exception):
    """Raised in place of building the datasets."""


def test_a_plain_run_opens_no_group(monkeypatch, tmp_path):
    """--device cpu and a plain --device cuda on a host with one GPU run one
    process with no group; a plain cuda on a host that shows several GPUs
    runs one process per GPU, an indexed one or the CPU one process."""
    def stop(config, wv_model):
        assert not torch.distributed.is_initialized()
        raise _Built

    monkeypatch.setattr(port_main, "build_datasets", stop)
    with pytest.raises(_Built):
        port_main.main(["--dataset", "synthetic", "--device", "cpu",
                        "--save_path", str(tmp_path)])
    assert not torch.distributed.is_initialized()
    for count, want in ((0, 1), (1, 1), (4, 4)):
        monkeypatch.setattr(torch.cuda, "device_count", lambda: count)
        assert port_main.local_world("cuda") == want
        assert port_main.local_world("cuda:1") == 1
        assert port_main.local_world("cpu") == 1


# ------------------------------------------------ the 2-process unit run ----

@pytest.fixture(scope="module")
def unit_run(tmp_path_factory):
    """Inputs for the 2-process unit run, its results and this process's
    references: synchronised BN against one BatchNorm3d on the whole batch,
    and two float32 steps of r3d_18 on global batches of 6 clips (rank 1's
    shard carries two weight-0 rows) against one port process and the JAX
    package's step on the whole batches, from one seeded Adam state."""
    tmp = tmp_path_factory.mktemp("unit")
    rng = np.random.default_rng(0)
    with torch.enable_grad():
        # --- BN: [N, C, T, H, W] with running statistics near the batch's
        c = 6
        x = torch.from_numpy(rng.normal(0.3, 1.2, (4, c, 2, 4, 4)).astype(
            np.float32))
        bn = PL.BatchNorm3d(c)
        with torch.no_grad():
            bn.weight.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, c)))
            bn.bias.copy_(torch.from_numpy(rng.normal(0, 0.2, c)))
            bn.running_mean.copy_(torch.from_numpy(rng.normal(0.3, 0.1, c)))
            bn.running_var.copy_(torch.from_numpy(rng.uniform(1, 2, c)))
        cot = torch.from_numpy(rng.normal(size=tuple(x.shape)).astype(
            np.float32))
        bn_in = {"x": x, "cotangent": cot,
                 "state": {k: v.clone() for k, v in bn.state_dict().items()}}
        stats = PL.bn_statistics(x.permute(0, 2, 3, 4, 1), bn.running_mean,
                                 bn.running_var, bn.momentum)
        xr = x.clone().requires_grad_()
        bn.train()
        (bn(xr, relu=True) * cot).sum().backward()
        bn_want = {"mean": stats[0].detach(), "var": stats[1].detach(),
                   "new_mean": stats[2], "new_var": stats[3],
                   "running_mean": bn.running_mean,
                   "running_var": bn.running_var, "dx": xr.grad,
                   "d_weight": bn.weight.grad, "d_bias": bn.bias.grad}

        # --- two train steps of 6 clips
        model, params, state = jax_weights(ARCH, seed=2,
                                           warm_shape=(6, 1, 2, 32, 32, 3))
        ce = rng.normal(size=(5, 300)).astype(np.float32)
        ce /= np.linalg.norm(ce, axis=1, keepdims=True)
        data = []
        for _ in range(2):
            labels = rng.integers(0, 5, 6).astype(np.int32)
            xb = rng.uniform(-0.5, 0, (6, 1, 2, 32, 32, 3)).astype(np.float32)
            w = np.asarray([1, 1, 1, 1, 0, 0], np.float32)
            data.append((xb, ce[labels], labels, w))
        m = port_model(params, state, ARCH)
        opt = make_optimizer(m.parameters(), 1e-3)
        seed_adam(opt, m, seed=3, count=1000)
        mu, nu, count = bridge.adam_to_jax(m, opt)
        # copies: the 1-D moments are views of the tensors the steps update
        mu, nu = (jax.tree.map(np.array, t) for t in (mu, nu))
        step = make_train_step(m, opt, compute_dtype=torch.float32)
        one = []
        for xb, z, labels, w in data:
            r = step(*[torch.from_numpy(a) for a in (xb, z, labels, w, ce)])
            one.append((float(r["loss"]), float(r["train_accuracy"])))
    ts, jax_metrics = jax_steps(model, params, state, data, ce, 1e-3,
                                (mu, nu), count)
    inp = tmp / "unit.pt"
    torch.save({"bn": bn_in, "step": {
        "arch": ARCH, "lr": 1e-3, "adam_seed": 3, "adam_count": 1000,
        "state_dict": bridge.from_jax(params, state),
        "class_embed": torch.from_numpy(ce),
        "batches": [[torch.from_numpy(a) for a in b] for b in data]}}, inp)
    outs, _ = launch(tmp, "unit", 2, inp)
    res = [torch.load(o, weights_only=True) for o in outs]
    for f in (inp, *outs):  # r3d_18's weights, ~130 MB each
        f.unlink()
    return {"ranks": res, "bn": bn_want, "one": one, "one_model": m,
            "jax": jax_metrics, "jax_ts": ts, "init": params}


def test_collectives_on_two_processes(unit_run):
    """gather_rows in rank order and bit-equal on both; all_reduce_sum and
    its gradient (the sum over the processes of each one's gradient);
    agree_from_process_zero takes process 0's value (or None) where the
    processes' own answers differ; sync_processes with differing tags
    raises on every process."""
    r0, r1 = unit_run["ranks"]
    want = torch.cat([torch.arange(6.0).reshape(2, 3),
                      torch.arange(6.0).reshape(2, 3) + 10])
    for r in (r0, r1):
        assert torch.equal(r["gathered"], want)
        assert torch.equal(r["reduced"], torch.full((3,), 3.0))
        assert torch.equal(r["reduced_grad"], torch.full((3,), 3.0))
        assert r["agreed"] == "/ckpt/from_p0.npz"
        assert r["agreed_none"] is None
        assert "different barriers" in r["mismatch"]


def test_synchronised_bn_equals_one_process(unit_run):
    """Each process holds half of one batch: mean, var, the new running
    statistics, and the gradients of a scalar of the output with respect to
    x (each half) and to the BN scale and bias (summed over the processes,
    as the step sums them) equal one process on the whole batch, rtol 1e-5
    and atol 1e-6."""
    want = unit_run["bn"]
    got = [r["bn"] for r in unit_run["ranks"]]
    for k in ("mean", "var", "new_mean", "new_var", "running_mean",
              "running_var", "d_weight", "d_bias"):
        for g in got:
            np.testing.assert_allclose(g[k].numpy(), want[k].numpy(),
                                       rtol=1e-5, atol=1e-6, err_msg=k)
    dx = torch.cat([g["dx"] for g in got])
    np.testing.assert_allclose(dx.numpy(), want["dx"].numpy(), rtol=1e-5,
                               atol=1e-6)


def test_train_steps_with_unequal_weight_sums(unit_run):
    """Two float32 steps on 2 processes of 3 clips (weight sums 3 and 1,
    where an average of the processes' gradients, as DDP's, is wrong)
    against one port process on the 6 clips and the JAX package's step on
    them: loss rtol 1e-4, parameters atol 2e-5; every parameter and BN
    statistic bit-equal across the processes."""
    r0, r1 = (r["step"] for r in unit_run["ranks"])
    assert r0["metrics"] == r1["metrics"]
    assert r0["count"] == r1["count"] == 1002
    for k in r0["state_dict"]:
        assert torch.equal(r0["state_dict"][k], r1["state_dict"][k]), k
    got = np.asarray(r0["metrics"])
    for ref in (unit_run["one"], unit_run["jax"]):
        np.testing.assert_allclose(got[:, 0], np.asarray(ref)[:, 0],
                                   rtol=1e-4)
        np.testing.assert_allclose(got[:, 1], np.asarray(ref)[:, 1])
    one = unit_run["one_model"].state_dict()
    for k, v in r0["state_dict"].items():
        if "running" in k or "tracked" in k:
            continue
        np.testing.assert_allclose(v.numpy(), one[k].numpy(), atol=2e-5,
                                   err_msg=k)
    got_p, got_s = bridge.to_jax(r0["state_dict"])
    want_p = bridge.flatten(jax.tree.map(np.asarray,
                                         unit_run["jax_ts"].params))
    for k, v in bridge.flatten(got_p).items():
        np.testing.assert_allclose(v, want_p[k], atol=2e-5, err_msg=k)
    want_s = bridge.flatten(jax.tree.map(np.asarray,
                                         unit_run["jax_ts"].model_state))
    for k, v in bridge.flatten(got_s).items():
        np.testing.assert_allclose(v, want_s[k], atol=1e-3, err_msg=k)
    # the steps moved the weights by far more than the bar
    moved = np.abs(bridge.flatten(got_p)["backbone/stem/conv1/w"]
                   - unit_run["init"]["backbone"]["stem"]["conv1"]["w"])
    assert moved.max() > 1e-4


# ------------------------------------------------ the evaluation ------------

@pytest.mark.parametrize("world", [4, 8])
def test_four_process_evaluation_of_a_ragged_table(tmp_path, world):
    """Experiment.evaluate on 4 (and 8) processes over the 15-row test
    table (4 + 4 + 4 + 3; 2 x 7 + 1), the last shard padded: every process
    reports the same accuracy, top-5, split mean and std over exactly 15
    samples, and these are one process's evaluation of the same table."""
    argv = SMALL + ["--class_total", "10", "--bs", "2", "--device", "cpu",
                    "--save_path", str(tmp_path / "runs")]
    cfg = port_main.config_from_namespace(
        port_main.build_arg_parser().parse_args(argv))
    model = get_network(Config(network=ARCH, head="mlp"))
    init_weights(model, torch.Generator().manual_seed(4))
    calibrate_bn(model, torch.from_numpy(np.random.default_rng(4).uniform(
        -0.5, 0, (4, 1, 2, 32, 32, 3)).astype(np.float32)), seed=4)
    sd = {k: v.clone() for k, v in model.state_dict().items()}
    inp = tmp_path / "eval.pt"
    torch.save({"argv": argv, "state_dict": sd}, inp)
    outs, _ = launch(tmp_path, "eval", world, inp)
    rs = [torch.load(o, weights_only=True) for o in outs]

    table = build_datasets(cfg, None)["testing"][0]
    exp = port_main.Experiment(cfg, {"training": [], "testing": [table]},
                               device="cpu")
    exp.model.load_state_dict(sd)
    want = exp.evaluate(table, 0)
    exp.log.close()
    assert len(table) == 15
    for r in rs:
        assert r["table_rows"] == 15
        assert r["local_rows"] == -(-15 // world)
        assert r["n_samples"] == 15
        for k in ("accuracy", "accuracy_top5", "accuracy_split_mean",
                  "accuracy_split_std"):
            assert r[k] == rs[0][k], k
            np.testing.assert_allclose(r[k], want[k], rtol=1e-6, err_msg=k)


# ------------------------------------------------ the trainer ---------------

def _files(root, pattern):
    import glob

    return sorted(glob.glob(os.path.join(root, "**", pattern),
                            recursive=True))


def test_two_process_trainer_writes_on_process_zero_and_resumes(tmp_path):
    """cli.main.main on 2 processes (one epoch, --checkpoint_every 1): both
    report the same loss, train accuracy, test accuracy and best accuracy;
    process 1 opens no file for writing under the save path, process 0
    writes one run directory with each CSV's one row, one metrics.jsonl and
    the checkpoints. A second 2-process run with --resume auto goes on at
    epoch 1 from the file process 0 chose."""
    runs = tmp_path / "runs"
    base = SMALL + ["--class_total", "4", "--train_samples", "16", "--bs",
                    "4", "--checkpoint_every", "1", "--device", "cpu",
                    "--save_path", str(runs)]
    inp = tmp_path / "cli.json"
    inp.write_text(json.dumps(base + ["--n_epochs", "1"]))
    outs, logs = launch(tmp_path, "cli", 2, inp)
    r0, r1 = (json.loads(o.read_text()) for o in outs)
    for k in ("loss", "train_accuracy", "synthetic_test_accuracy",
              "best_accuracy"):
        assert r0["summary"][k] == r1["summary"][k], k
    assert np.isfinite(r0["summary"]["loss"])
    assert r1["writes"] == [], r1["writes"]
    assert any(w.endswith("last.npz") for w in r0["writes"]), r0["writes"]
    run_dirs = {os.path.dirname(f) for f in _files(runs, "metrics.jsonl")}
    assert len(run_dirs) == 1 and len(_files(runs, "metrics.jsonl")) == 1
    run_dir = run_dirs.pop()
    assert "_BS8_" in run_dir  # savename of the global batch, 4 x 2
    csvs = _files(runs, "*.csv")
    assert csvs and all(len(open(f).readlines()) == 1 for f in csvs)
    lasts = _files(runs, "last.npz")
    assert lasts == [os.path.join(run_dir, "last.npz")]
    assert read_meta(lasts[0])["epoch"] == 0
    best = _files(runs, "checkpoint.npz")
    assert len(best) == int(r0["summary"]["best_accuracy"] > 0)
    assert len(_files(runs, "train_samples_*.txt")) == 1

    inp.write_text(json.dumps(base + ["--n_epochs", "2", "--resume",
                                      "auto"]))
    for f in tmp_path.glob("cli_*.out"):
        f.unlink()
    store = str(tmp_path / "cli_store_resume")
    outs, logs = launch(tmp_path, "cli", 2, inp, store=store)
    r0, r1 = (json.loads(o.read_text()) for o in outs)
    for log in logs:
        assert f"RESUME auto: {lasts[0]}" in log
        assert f"RESUMED: {lasts[0]} at epoch 1" in log
    assert r1["writes"] == []
    assert read_meta(lasts[0])["epoch"] == 1
    for k in ("loss", "train_accuracy", "synthetic_test_accuracy",
              "best_accuracy"):
        assert r0["summary"][k] == r1["summary"][k], k
    assert len(_files(runs, "metrics.jsonl")) == 1  # the same directory


# ------------------------------------------- the whole trainer against JAX --

@pytest.mark.slow
def test_two_process_trainer_matches_the_jax_trainer(tmp_path):
    """The port's cli.main on 2 processes against the JAX package's under
    jax.distributed on 2 processes of one CPU device each: the same 2 data
    shards, local batch and table shards. Both resume one JAX checkpoint
    (warmed BN statistics, a seeded Adam state, epoch -1) and train epoch
    0 (2 steps of 8 clips) with its evaluation: loss and train accuracy
    rtol 1e-4, the test accuracy equal, the parameters of the last.npz
    each writes atol 2e-5."""
    model, params, state = jax_weights(ARCH, seed=5,
                                       warm_shape=(8, 1, 2, 32, 32, 3))
    m = port_model(params, state, ARCH)
    opt = make_optimizer(m.parameters(), 1e-3)
    seed_adam(opt, m, seed=6, count=1000)
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
                    "4", "--n_epochs", "1", "--checkpoint_every", "1"]
    out = {}
    for side in ("jax", "port"):
        ckpt = str(tmp_path / side / "run" / "last.npz")
        jax_save_checkpoint(ckpt, ts, epoch=-1, accuracy=0.0)
        argv = args + ["--resume", ckpt, "--save_path",
                       str(tmp_path / side / "runs")]
        if side == "port":
            argv += ["--device", "cpu"]
        inp = tmp_path / f"{side}.json"
        inp.write_text(json.dumps(argv))
        if side == "jax":
            s = socket.socket()
            s.bind(("127.0.0.1", 0))
            store = f"127.0.0.1:{s.getsockname()[1]}"
            s.close()
            outs, _ = launch(tmp_path, "jaxcli", 2, inp, store=store)
        else:
            outs, _ = launch(tmp_path, "cli", 2, inp)
        rs = [json.loads(o.read_text()) for o in outs]
        for k in ("loss", "train_accuracy", "synthetic_test_accuracy"):
            assert rs[0]["summary"][k] == rs[1]["summary"][k], (side, k)
        out[side] = (rs[0], read_checkpoint(ckpt)[0])
    (jr, jparams), (pr, pparams) = out["jax"], out["port"]
    assert jr["process_count"] == jr["device_count"] == 2
    assert pr["process_count"] == 2
    for k in ("loss", "train_accuracy"):
        np.testing.assert_allclose(pr["summary"][k], jr["summary"][k],
                                   rtol=1e-4, err_msg=k)
    assert (pr["summary"]["synthetic_test_accuracy"]
            == jr["summary"]["synthetic_test_accuracy"])
    assert pparams.keys() == jparams.keys()
    for k in jparams:
        np.testing.assert_allclose(pparams[k], jparams[k], atol=2e-5,
                                   err_msg=k)


# ------------------------------------------- the kernels' build -------------

def test_two_processes_that_start_at_once_build_the_kernels_once(tmp_path):
    """Two processes (two ranks at their first kernel use) call
    _build.build() at once: its file lock lets one compile and the other
    find the library, so nvcc runs once per source and links once. A
    stand-in nvcc on PATH records its calls and writes its -o file after a
    second."""
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir()
    nvcc = bin_dir / "nvcc"
    nvcc.write_text('#!/bin/sh\necho "$@" >> "$NVCC_CALLS"\nsleep 1\n'
                    'while [ $# -gt 0 ]; do\n'
                    '  if [ "$1" = "-o" ]; then shift; : > "$1"; fi\n'
                    '  shift\ndone\n')
    nvcc.chmod(0o755)
    calls = tmp_path / "calls.txt"
    code = ("import pathlib, sys\n"
            "from zeroshotvideoclassification_tpu_torch import _build\n"
            "_build.BUILD_ROOT = pathlib.Path(sys.argv[1])\n"
            "print('COMPILED', _build.build().compiled)\n")
    env = dict(os.environ, PYTHONPATH=ROOT, NVCC_CALLS=str(calls),
               PATH=f"{bin_dir}{os.pathsep}{os.environ.get('PATH', '')}")
    procs = [subprocess.Popen([sys.executable, "-c", code,
                               str(tmp_path / "build")], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
             for _ in range(2)]
    try:
        outs = [p.communicate(timeout=LAUNCH_TIMEOUT)[0].decode()
                for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert all(p.returncode == 0 for p in procs), outs
    assert sorted(o.strip().splitlines()[-1] for o in outs) == [
        "COMPILED False", "COMPILED True"]
    from zeroshotvideoclassification_tpu_torch import _build

    lines = calls.read_text().splitlines()
    assert len(lines) == len(_build.sources()) + 1  # each source, one link
    assert sum("-shared" in ln for ln in lines) == 1
