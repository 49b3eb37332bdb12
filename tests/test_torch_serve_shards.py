"""The port's serving engine over several replicas: over ["cpu"] * 8, the
stand-in for the JAX suite's 8 virtual devices, against the JAX engine
meshed over them (the ladder rounded up to tile the shards, data_shards,
the embeddings and the ranked results), and its mechanics: requests of
fewer rows than shards and of none, one device thread per replica, a
warmup that counts nothing and fills no bucket past max_batch, a reload
that swaps every replica, a replica's error raised, and how `cuda`
resolves to every GPU. r3d_18, 1 clip of 2x32x32, float32."""

import threading

import numpy as np
import pytest
import torch

from test_torch_model import _save_jax_checkpoint, jax_weights
from test_torch_serve import CLASSES, _assert_same_results
from torch_helpers import remove_large_files

N = 8  # replicas: the virtual devices of tests/conftest.py
KW = dict(network="r3d_18", head="mlp", n_clips=1, clip_len=2, size=32,
          compute_dtype="float32")


@pytest.fixture(autouse=True)
def drop_large_files(tmp_path):
    """Delete the test's large files when it ends
    (torch_helpers.remove_large_files)."""
    yield
    remove_large_files(tmp_path)


@pytest.fixture(scope="module")
def shards(tmp_path_factory):
    from zeroshotvideoclassification_tpu.serve import (
        InferenceEngine as JaxEngine,
    )
    from zeroshotvideoclassification_tpu.text import classes2embedding
    from zeroshotvideoclassification_tpu.text.word2vec import (
        SyntheticWordVectors,
    )
    from zeroshotvideoclassification_tpu_torch.serve import InferenceEngine
    from torch_helpers import synthetic_clip

    tmp = tmp_path_factory.mktemp("serve_shards")
    paths = []
    for i in range(5):
        p = tmp / f"clip{i}.npy"
        np.save(p, synthetic_clip(20 + i, 8, 48, 64))
        paths.append(str(p))
    ckpts = []
    for seed in (8, 9):
        _, params, state = jax_weights("r3d_18", seed=seed)
        ckpt = tmp / f"ckpt{seed}.npz"
        _save_jax_checkpoint(ckpt, params, state)
        ckpts.append(str(ckpt))
    class_embed = classes2embedding("kinetics", CLASSES,
                                    SyntheticWordVectors())
    jax_engine = JaxEngine(CLASSES, class_embed, weights=ckpts[0],
                           max_batch=4, **KW)
    engine = InferenceEngine(CLASSES, class_embed, weights=ckpts[0],
                             max_batch=4, device=["cpu"] * N, **KW)
    one = InferenceEngine(CLASSES, class_embed, weights=ckpts[0],
                          max_batch=4, device="cpu", **KW)
    yield {"jax": jax_engine, "port": engine, "one": one, "paths": paths,
           "ckpts": ckpts, "class_embed": class_embed}
    for e in (engine, one, jax_engine):
        e.close()
    remove_large_files(tmp)


@pytest.mark.parametrize("max_batch", [4, 12, 16])
def test_ladder_and_data_shards_match_the_jax_engine(shards, max_batch):
    """Every bucket rounded up to a multiple of the 8 shards, as the JAX
    engine's _fit: [8] at max_batch 4, [8, 16] at 12 and 16."""
    from zeroshotvideoclassification_tpu.serve import (
        InferenceEngine as JaxEngine,
    )
    from zeroshotvideoclassification_tpu_torch.serve import InferenceEngine

    ce = shards["class_embed"]
    jax_engine = JaxEngine(CLASSES, ce, max_batch=max_batch, **KW)
    engine = InferenceEngine(CLASSES, ce, max_batch=max_batch,
                             device=["cpu"] * N, **KW)
    try:
        assert engine.batch_buckets == jax_engine.batch_buckets
        assert all(b % N == 0 for b in engine.batch_buckets)
        assert (engine.stats()["data_shards"]
                == jax_engine.stats()["data_shards"] == N)
        assert engine.stats()["device"] == ",".join(["cpu"] * N)
    finally:
        engine.close()
        jax_engine.close()


def test_embeddings_and_ranking_match_the_jax_engine(shards):
    """4 videos in a bucket of 8 split over 8 replicas (4 of them only
    padding): embeddings within atol 1e-4 of the JAX engine's over its 8
    devices, the same ranked classes and similarities."""
    paths = shards["paths"][:4]
    want, want_ok = shards["jax"].embed_paths(paths)
    got, ok = shards["port"].embed_paths(paths)
    assert got.shape == (4, 300) and ok.all() and want_ok.all()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    # every row is far nearer its own JAX row than any other video's: the
    # replicas' slices come back in device order
    err = np.abs(got - want).max()
    sep = min(np.abs(got[i] - want[j]).max()
              for i in range(4) for j in range(4) if i != j)
    assert sep > 10 * err
    _assert_same_results(shards["port"].classify(paths),
                         shards["jax"].classify(paths))


def test_fewer_rows_than_shards_and_an_empty_request(shards):
    """One video (7 replicas run padding only) gives the one-replica
    engine's embedding (a bucket of 8 in one forward) within atol 1e-6;
    an empty request gives no rows and no results."""
    engine, one = shards["port"], shards["one"]
    got, ok = engine.embed_paths(shards["paths"][4:5])
    want, want_ok = one.embed_paths(shards["paths"][4:5])
    assert got.shape == (1, 300) and ok.tolist() == [True] == want_ok.tolist()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    emb, ok = engine.embed_paths([])
    assert emb.shape == (0, 300) and ok.shape == (0,)
    assert engine.classify([]) == []


def test_each_replica_runs_on_its_own_device_thread(shards, monkeypatch):
    """A dispatch runs replica i's forward on thread zsvc-device-i, with
    rows [i b/8, (i+1) b/8) of the bucket's host batch, whichever thread
    calls: 8 distinct threads, the same ones for every dispatch."""
    engine = shards["port"]
    seen = []
    forward = engine._forward

    def spy(model, hb, device):
        seen.append((threading.current_thread().name,
                     hb.canvas.copy(), device))
        return forward(model, hb, device)

    monkeypatch.setattr(engine, "_forward", spy)
    packed = engine.pack_paths(shards["paths"][:3])
    assert packed["bucket"] == 8
    th = threading.Thread(target=engine.dispatch_packed, args=(packed,))
    th.start()
    th.join(timeout=120)
    assert not th.is_alive() and len(seen) == N
    names = sorted(name for name, _, _ in seen)
    assert len(set(names)) == N
    for name, canvas, device in seen:
        i = int(name.split("_")[0].rsplit("-", 1)[1])
        assert name.startswith(f"zsvc-device-{i}")
        assert device == engine.devices[i]
        np.testing.assert_array_equal(canvas, packed["hb"].canvas[i:i + 1])
    engine.classify(shards["paths"][:1])
    assert sorted(name for name, _, _ in seen[N:2 * N]) == names


def test_warmup_counts_nothing_and_fills_no_bucket_past_max_batch(shards):
    """max_batch 12 over 8 replicas: buckets [8, 16]; warmup packs 8 and
    12 paths (never 16 > max_batch, which pack_paths refuses), runs every
    bucket on every replica and leaves the counters at 0."""
    from zeroshotvideoclassification_tpu_torch.serve import InferenceEngine

    engine = InferenceEngine(CLASSES, shards["class_embed"], max_batch=12,
                             device=["cpu"] * N, **KW)
    packed = []
    pack = engine.pack_paths

    def spy(paths):
        packed.append(len(paths))
        return pack(paths)

    engine.pack_paths = spy
    try:
        assert engine.batch_buckets == [8, 16]
        with pytest.raises(ValueError, match="max_batch"):
            pack(["/nonexistent/x.npy"] * 16)
        engine.warmup()
        stats = engine.stats()
    finally:
        engine.close()
    assert packed == [8, 12]
    assert stats["dispatches"] == 0 and stats["device_seconds"] == 0
    assert stats["batch_buckets"] == {"8": 0, "16": 0}


def test_a_reload_swaps_every_replica(shards):
    """reload() builds new models and swaps them on every replica in one
    assignment: every replica's model is new and the embeddings are the
    new checkpoint's (as a one-replica engine loaded with it gives);
    reloading the first checkpoint restores the first embeddings."""
    from zeroshotvideoclassification_tpu_torch.serve import InferenceEngine

    engine, paths = shards["port"], shards["paths"][:2]
    before, old = engine.embed_paths(paths)[0], engine.models
    try:
        res = engine.reload(shards["ckpts"][1])
        assert res["reloaded"] == shards["ckpts"][1] and res["epoch"] == 3
        assert len(engine.models) == N
        assert all(all(m is not o for o in old) for m in engine.models)
        got = engine.embed_paths(paths)[0]
        other = InferenceEngine(CLASSES, shards["class_embed"],
                                weights=shards["ckpts"][1], max_batch=4,
                                device="cpu", **KW)
        try:
            want = other.embed_paths(paths)[0]
        finally:
            other.close()
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
        assert np.abs(got - before).max() > 1e-3
    finally:
        engine.reload(shards["ckpts"][0])
    np.testing.assert_array_equal(engine.embed_paths(paths)[0], before)


def test_a_replica_that_fails_raises(shards, monkeypatch):
    """A replica's error propagates out of the dispatch; the other
    replicas do not serve in its place."""
    engine = shards["port"]
    forward = engine._forward

    def failing(model, hb, device):
        if threading.current_thread().name.startswith("zsvc-device-5"):
            raise RuntimeError("replica 5 failed")
        return forward(model, hb, device)

    monkeypatch.setattr(engine, "_forward", failing)
    with pytest.raises(RuntimeError, match="replica 5 failed"):
        engine.embed_paths(shards["paths"][:2])


def test_cuda_resolves_to_every_gpu(monkeypatch):
    """--device cuda: every GPU torch.cuda.device_count() shows; cuda:1:
    that one; cpu: one CPU replica; a list: each entry (repeats kept)."""
    from zeroshotvideoclassification_tpu_torch.cli.infer import (
        resolve_devices,
    )

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert resolve_devices("cuda") == [torch.device("cuda", i)
                                       for i in range(4)]
    assert resolve_devices(torch.device("cuda")) == resolve_devices("cuda")
    assert resolve_devices("cuda:1") == [torch.device("cuda", 1)]
    assert resolve_devices("cpu") == [torch.device("cpu")]
    assert resolve_devices(["cuda:0", "cuda:0"]) == [torch.device("cuda",
                                                                  0)] * 2
    with pytest.raises(ValueError):
        resolve_devices([])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_devices("cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_devices(["cpu", "cuda:0"])
