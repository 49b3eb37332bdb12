"""The dropout streams of the PyTorch port's trainer across processes, on
the CPU under gloo: each data shard draws its own masks (the JAX package
draws one mask over the global batch, so the shards' rows are dropped
independently), also on the CPU, whose torch.Generator keeps 32 bits of
its seed; data index 0 draws what a single process draws, from (seed <<
16) + epoch; the members of a model group (--tp), which see the same rows,
draw one mask. The processes are tests/torch_parallel_worker.py's (mode
tp_epoch) at tests/test_torch_parallel.py's sizes, with --network resnet18
(R3D-18 + the linear head, dropout 0.05)."""

import json

import pytest
import torch

from zeroshotvideoclassification_tpu_torch.cli.main import dropout_seed

from test_torch_parallel import SMALL, launch
from torch_helpers import remove_large_files


@pytest.fixture(autouse=True)
def drop_large_files(tmp_path):
    """Delete the test's large files when it ends
    (torch_helpers.remove_large_files)."""
    yield
    remove_large_files(tmp_path)


@pytest.fixture(autouse=True)
def grad_enabled():
    """Another test module switches autograd off for its whole process when
    it is imported; the trainer's steps differentiate."""
    with torch.enable_grad():
        yield


def test_data_index_zero_keeps_the_single_process_seed():
    """dropout_seed at data index 0 is (seed << 16) + epoch, the seed every
    single-process run and --tp 1 checkpoint's resumed epoch draws from."""
    for seed in (0, 1, 7, 2 ** 20 + 3):
        for epoch in (0, 1, 5, 99):
            assert dropout_seed(seed, epoch, 0) == (seed << 16) + epoch


def test_every_data_shard_and_epoch_has_its_own_cpu_stream():
    """The seeds of 64 data shards over 100 epochs of one run differ in the
    32 bits a CPU generator keeps, and 8 shards' first draws differ."""
    low = {dropout_seed(1, e, d) & 0xFFFFFFFF for e in range(100)
           for d in range(64)}
    assert len(low) == 100 * 64
    draws = {float(torch.rand(1, generator=torch.Generator().manual_seed(
        dropout_seed(1, 0, d)))) for d in range(8)}
    assert len(draws) == 8


def _first_masks(tmp_path, extra):
    argv = SMALL + ["--class_total", "4", "--train_samples", "8", "--bs",
                    "4", "--device", "cpu", "--network", "resnet18",
                    "--save_path", str(tmp_path / "runs"), *extra]
    inp = tmp_path / "epoch.json"
    inp.write_text(json.dumps(argv))
    outs, _ = launch(tmp_path, "tp_epoch", 2, inp)
    return [{**r["first_dropout"], "seed": r["seed"], "grid": r["grid"]}
            for r in (torch.load(o, weights_only=True) for o in outs)]


def test_data_shards_draw_their_own_dropout_masks(tmp_path):
    """Two data shards (2 gloo processes, --tp 1): the first masks differ;
    data index 0's generator is the one seeded with (seed << 16) + epoch
    (= 1 << 16 at --seed 1, epoch 0) and draws that seed's mask."""
    r0, r1 = _first_masks(tmp_path, [])
    assert r0["grid"] == [2, 1, 0, 0] and r1["grid"] == [2, 1, 1, 0]
    assert r0["rate"] == r1["rate"] == 0.05
    assert r0["mask"].shape == r1["mask"].shape
    assert not torch.equal(r0["mask"], r1["mask"])
    assert r0["seed"] == 1 << 16
    want = torch.Generator().manual_seed(1 << 16)
    assert torch.equal(r0["state"], want.get_state())
    assert torch.equal(r0["mask"],
                       torch.rand(r0["mask"].shape, generator=want) < 0.95)


def test_a_model_group_draws_one_dropout_mask(tmp_path):
    """The two members of a 1 x 2 grid (--tp 2) share data index 0 and draw
    the same first mask from the same generator state."""
    r0, r1 = _first_masks(tmp_path, ["--tp", "2"])
    assert r0["grid"] == [1, 2, 0, 0] and r1["grid"] == [1, 2, 0, 1]
    assert r0["seed"] == r1["seed"] == 1 << 16
    assert torch.equal(r0["state"], r1["state"])
    assert torch.equal(r0["mask"], r1["mask"])
    assert r0["mask"].float().mean() < 1.0
