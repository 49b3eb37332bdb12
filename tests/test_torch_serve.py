"""The serving slice as a whole: the JAX InferenceEngine and the port's, on
the same checkpoint and the same .npy clips, give the same embeddings,
top classes and similarities — directly, through the shared HTTP server,
and through the port's one-shot CLI; a mismatched /reload is refused."""

import argparse
import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest

from test_torch_model import jax_weights, _save_jax_checkpoint

CLASSES = ["playing guitar", "riding a horse", "washing dishes",
           "juggling balls"]
KW = dict(network="r2plus1d_18", head="mlp", n_clips=2, clip_len=4, size=32,
          max_batch=4, compute_dtype="float32")


@pytest.fixture(scope="module")
def slice_(tmp_path_factory):
    from zeroshotvideoclassification_tpu.serve import (
        InferenceEngine as JaxEngine,
    )
    from zeroshotvideoclassification_tpu.text import classes2embedding
    from zeroshotvideoclassification_tpu.text.word2vec import (
        SyntheticWordVectors,
    )
    from zeroshotvideoclassification_tpu_torch.serve import (
        InferenceEngine,
        start_server,
    )
    from torch_helpers import synthetic_clip

    tmp = tmp_path_factory.mktemp("torch_serve")
    paths = []
    for i in range(5):
        p = tmp / f"clip{i}.npy"
        np.save(p, synthetic_clip(i, 12, 64, 86))
        paths.append(str(p))
    _, params, state = jax_weights("r2plus1d_18", seed=5)
    ckpt = tmp / "ckpt.npz"
    _save_jax_checkpoint(ckpt, params, state)
    class_embed = classes2embedding("kinetics", CLASSES,
                                    SyntheticWordVectors())
    jax_engine = JaxEngine(CLASSES, class_embed, weights=str(ckpt), **KW)
    engine = InferenceEngine(CLASSES, class_embed, weights=str(ckpt),
                             device="cpu", **KW)
    server, service = start_server(engine, port=0, max_wait_s=0.05)
    yield {"jax": jax_engine, "port": engine, "paths": paths,
           "ckpt": str(ckpt), "tmp": tmp, "class_embed": class_embed,
           "url": f"http://127.0.0.1:{server.server_address[1]}"}
    server.shutdown()
    server.server_close()
    service.close()
    engine.close()
    jax_engine.close()


def _post(url, payload):
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 method="POST")
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _get(url):
    with urllib.request.urlopen(url, timeout=60) as r:
        return json.loads(r.read())


def _assert_same_results(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g["video"] == w["video"]
        assert g["top_class"] == w["top_class"]
        assert [t["class"] for t in g["topk"]] == [t["class"]
                                                   for t in w["topk"]]
        np.testing.assert_allclose([t["similarity"] for t in g["topk"]],
                                   [t["similarity"] for t in w["topk"]],
                                   atol=1e-4)


def test_port_engine_matches_jax_engine(slice_):
    paths = slice_["paths"][:4]
    want_emb, want_ok = slice_["jax"].embed_paths(paths)
    got_emb, got_ok = slice_["port"].embed_paths(paths)
    assert got_emb.shape == (4, 300) and got_ok.all() and want_ok.all()
    np.testing.assert_allclose(got_emb, want_emb, atol=1e-4, rtol=0)
    # the clips are told apart (the check above is not trivially met)
    assert np.abs(got_emb[0] - got_emb[1]).max() > 1e-3
    _assert_same_results(slice_["port"].classify(paths),
                         slice_["jax"].classify(paths))


def test_http_classify_matches_direct(slice_):
    paths = slice_["paths"]
    want = slice_["jax"].classify(paths[:4]) + slice_["jax"].classify(
        paths[4:])
    code, body = _post(slice_["url"] + "/classify", {"videos": paths})
    assert code == 200
    _assert_same_results(body["results"], want)
    code, one = _post(slice_["url"] + "/classify", {"video": paths[2]})
    assert code == 200 and one["top_class"] == want[2]["top_class"]
    health = _get(slice_["url"] + "/healthz")
    assert health == {"status": "ok", "network": "r2plus1d_18",
                      "classes": len(CLASSES)}
    stats = _get(slice_["url"] + "/stats")
    assert stats["engine"]["dispatches"] >= 2
    assert stats["engine"]["device"] == "cpu"
    assert stats["engine"]["weights"] == slice_["ckpt"]


def test_missing_video_is_a_decode_failure(slice_):
    res = slice_["port"].classify([slice_["paths"][0], "/nonexistent/x.npy"])
    assert "top_class" in res[0]
    assert res[1] == {"video": "/nonexistent/x.npy", "error": "decode failed"}


def test_mismatched_reload_is_refused(slice_, tmp_path):
    _, p3, s3 = jax_weights("r3d_18", seed=6)
    bad = tmp_path / "r3d.npz"
    _save_jax_checkpoint(bad, p3, s3)
    before = slice_["port"].embed_paths(slice_["paths"][:1])[0]
    code, body = _post(slice_["url"] + "/reload", {"weights": str(bad)})
    assert code == 500 and "does not match" in body["error"]
    code, body = _post(slice_["url"] + "/reload", {"weights": "none"})
    assert code == 400
    assert slice_["port"].weights_path == slice_["ckpt"]
    np.testing.assert_array_equal(
        slice_["port"].embed_paths(slice_["paths"][:1])[0], before)
    # the same checkpoint reloads
    code, body = _post(slice_["url"] + "/reload",
                       {"weights": slice_["ckpt"]})
    assert code == 200 and body["reloaded"] == slice_["ckpt"]
    assert body["epoch"] == 3


def test_port_cli_matches_engine(slice_):
    from zeroshotvideoclassification_tpu_torch.cli.infer import (
        classify_videos,
    )

    args = argparse.Namespace(
        network="r2plus1d_18", head="mlp", weights=slice_["ckpt"], n_clips=2,
        clip_len=4, size=32, bs=4, top_k=5, compute_dtype="float32",
        decode_scale=1, device="cpu")
    paths = slice_["paths"]
    want = slice_["port"].classify(paths[:4]) + slice_["port"].classify(
        paths[4:])
    _assert_same_results(classify_videos(paths, CLASSES,
                                         slice_["class_embed"], args), want)


def test_infer_cli_main(slice_, capsys):
    from zeroshotvideoclassification_tpu_torch.cli.infer import main

    paths = slice_["paths"][:2]
    results = main(["--videos", *paths, "--classes", *CLASSES,
                    "--synthetic_word2vec", "--weights", slice_["ckpt"],
                    "--n_clips", "2", "--clip_len", "4", "--size", "32",
                    "--compute_dtype", "float32", "--device", "cpu"])
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert lines == results
    _assert_same_results(results, slice_["port"].classify(paths))


def test_ladder_and_warmup(slice_):
    engine = slice_["port"]
    assert engine.batch_buckets == [4]
    before = engine.stats()["dispatches"]
    engine.warmup()
    assert engine.stats()["dispatches"] == before


def test_device_work_runs_on_one_engine_thread(slice_, monkeypatch):
    """Whichever thread calls, the forward runs on the engine's own device
    thread (cuDNN's handles and timed-algorithm tables are per-thread)."""
    engine = slice_["port"]
    seen = []
    step = engine.eval_step

    def spy(model, x):
        seen.append(threading.current_thread().name)
        return step(model, x)

    monkeypatch.setattr(engine, "eval_step", spy)
    engine.classify(slice_["paths"][:1])
    th = threading.Thread(target=engine.classify,
                          args=(slice_["paths"][1:2],))
    th.start()
    th.join(timeout=120)
    assert not th.is_alive() and len(seen) == 2
    assert len(set(seen)) == 1 and seen[0].startswith("zsvc-device")


def test_serve_cli_has_the_jax_flags_plus_device():
    from zeroshotvideoclassification_tpu.cli.serve import (
        build_arg_parser as jax_parser,
    )
    from zeroshotvideoclassification_tpu_torch.cli.serve import (
        build_arg_parser,
    )

    jax_flags = {a.dest for a in jax_parser()._actions}
    port_flags = {a.dest for a in build_arg_parser()._actions}
    assert port_flags == jax_flags | {"device"}
    args = build_arg_parser().parse_args(["--classes", "a"])
    assert args.device == "cuda" and args.max_batch == 128


def test_cuda_device_without_gpu_raises():
    import torch

    from zeroshotvideoclassification_tpu_torch.cli.infer import (
        resolve_device,
    )

    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device("cuda")
