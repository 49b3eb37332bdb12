"""The port's offline tools (tools/) against the JAX package's on the same
inputs: prepare_word2vec on a tiny binary, caption_vocab, the ActivityNet
extractor, port_checkpoint of torchvision-layout .pth files written from
seeded r2plus1d_18 / mc3_18 models, of a C3D pickle-layout file and of a
reference checkpoint.pth.tar (the npz's members, shapes, dtypes, values
and meta equal; each package's warm_start loads the other's file), and
extract_captions' message without transformers."""

import argparse
import io
import json
import os
import struct
import sys

import numpy as np
import pytest
import torch

from zeroshotvideoclassification_tpu.tools import (
    caption_vocab as jax_caption_vocab,
    extract_activitynet_clips as jax_anet,
    extract_captions as jax_captions,
    port_checkpoint as jax_port,
    prepare_word2vec as jax_w2v,
)
from zeroshotvideoclassification_tpu_torch.config import Config
from zeroshotvideoclassification_tpu_torch.models import get_network
from zeroshotvideoclassification_tpu_torch.models.layers import init_weights
from zeroshotvideoclassification_tpu_torch.tools import (
    caption_vocab,
    extract_activitynet_clips as anet,
    extract_captions,
    port_checkpoint,
    prepare_word2vec,
)
from zeroshotvideoclassification_tpu_torch.train import warm_start


def _npz(path, allow_pickle=False):
    with np.load(path, allow_pickle=allow_pickle) as z:
        return {k: z[k] for k in z.files}


def _same_npz(got, want, allow_pickle=False):
    """The same members, shapes, dtypes and values."""
    a, b = _npz(got, allow_pickle), _npz(want, allow_pickle)
    assert sorted(a) == sorted(b)
    for k in b:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    return a


def _run_both(port_main, jax_main, port_argv, jax_argv, capsys):
    """Each main with its own arguments -> (port's stdout, JAX's stdout)."""
    port_main(port_argv)
    port_out = capsys.readouterr().out
    jax_main(jax_argv)
    return port_out, capsys.readouterr().out


# ------------------------------------------------------- prepare_word2vec --

def _tiny_bin(path):
    """A word2vec binary of 3 words (as tests/test_text.py writes one)."""
    dim, words = 4, ["cat", "dog", "running"]
    vecs = np.random.default_rng(1).normal(size=(3, dim)).astype(np.float32)
    buf = io.BytesIO()
    buf.write(f"{len(words)} {dim}\n".encode())
    for w, v in zip(words, vecs):
        buf.write(w.encode() + b" ")
        buf.write(struct.pack("<%df" % dim, *v))
    path.write_bytes(buf.getvalue())


@pytest.mark.parametrize("limit", [[], ["--limit", "2"]])
def test_prepare_word2vec_matches_jax(tmp_path, capsys, limit):
    src = tmp_path / "mini.bin"
    _tiny_bin(src)
    outs = [str(tmp_path / f"{who}.npz") for who in ("port", "jax")]
    got, want = _run_both(
        prepare_word2vec.main, jax_w2v.main,
        ["--bin", str(src), "--out", outs[0], *limit],
        ["--bin", str(src), "--out", outs[1], *limit], capsys)
    assert got.replace("port.npz", "jax.npz") == want
    assert got.startswith(f"wrote {outs[0]} (")
    z = _same_npz(*outs, allow_pickle=True)  # the words: an object array
    assert len(z) > 0


# --------------------------------------------------------- caption_vocab ---

def test_caption_vocab_matches_jax(tmp_path, capsys):
    root = tmp_path / "frames"
    for name, caps in (("vid_a", ["A dog is running fast.", "The dog jumps!"]),
                       ("vid_b", ["Dog, dog, DOG.", "two people dance"])):
        (root / name).mkdir(parents=True)
        with open(root / name / "captions.json", "w") as f:
            json.dump(caps, f)
    outs = [tmp_path / f"{who}.json" for who in ("port", "jax")]
    got, want = _run_both(
        caption_vocab.main, jax_caption_vocab.main,
        ["--captions_root", str(root), "--out", str(outs[0])],
        ["--captions_root", str(root), "--out", str(outs[1])], capsys)
    assert got == want
    assert outs[0].read_text() == outs[1].read_text()
    for w in ["dog", "running", "blue", "quickly", "zzzzqq", "jumps"]:
        assert caption_vocab.pos_bucket(w) == jax_caption_vocab.pos_bucket(w)


# --------------------------------------------- extract_activitynet_clips ---

def test_activitynet_extractor_matches_jax(tmp_path):
    """The CSV and every clip written by main (one worker) are the JAX
    tool's, byte for byte, on a synthesized MJPG video (as
    tests/test_activitynet_tools.py builds it); extract_one's return
    values agree."""
    pytest.importorskip("cv2")
    from test_activitynet_tools import _make_source

    src, database = _make_source(tmp_path)
    dests = [tmp_path / who for who in ("port", "jax")]
    anet.main(["--source", str(src), "--dest", str(dests[0]),
               "--workers", "1"])
    jax_anet.main(["--source", str(src), "--dest", str(dests[1]),
                   "--workers", "1"])
    names = sorted(os.listdir(dests[1]))
    assert sorted(os.listdir(dests[0])) == names
    assert names == ["annotations_all.csv", "v_test1_0.npy", "v_test1_1.npy"]
    for n in names:
        assert (dests[0] / n).read_bytes() == (dests[1] / n).read_bytes(), n
    for ident in ("v_test1", "v_skipme", "v_absent"):
        assert (anet.extract_one(str(src), str(dests[0]), ident,
                                 database[ident])
                == jax_anet.extract_one(str(src), str(dests[1]), ident,
                                        database[ident]))


# -------------------------------------------------------- port_checkpoint --

def _seeded(network, head="mlp", seed=0):
    """A port model with seeded weights and BN statistics."""
    m = get_network(Config(network=network, head=head))
    init_weights(m, torch.Generator().manual_seed(seed))
    g = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for k, v in m.state_dict().items():
            if k.endswith("running_mean"):
                v.copy_(torch.randn(v.shape, generator=g) * 0.1)
            elif k.endswith("running_var"):
                v.copy_(torch.rand(v.shape, generator=g) + 0.5)
    return m


def _source(kind, network, path):
    """Write a torch source of `kind` for `network` to `path`."""
    if kind == "torchvision":
        sd = _seeded(network).state_dict()
        tv = {k[len("model."):]: v for k, v in sd.items()
              if k.startswith("model.")}
        g = torch.Generator().manual_seed(5)
        tv["fc.weight"] = torch.randn(400, 512, generator=g)
        tv["fc.bias"] = torch.randn(400, generator=g)
        torch.save(tv, path)
    elif kind == "reference":
        sd = _seeded(network, seed=3).state_dict()
        torch.save({"state_dict": {f"module.{k}": v for k, v in sd.items()},
                    "opt": argparse.Namespace(network=network, lr=1e-3),
                    "accuracy": 31.5}, path)
    else:  # DavideA's c3d.pickle layout, at small widths
        g = torch.Generator().manual_seed(7)
        sd, ci = {}, 3
        for name in ("conv1", "conv2", "conv3a", "conv3b", "conv4a",
                     "conv4b", "conv5a", "conv5b"):
            sd[name + ".weight"] = torch.randn(4, ci, 3, 3, 3, generator=g)
            sd[name + ".bias"] = torch.randn(4, generator=g)
            ci = 4
        for name, shape in (("fc6", (6, 8)), ("fc7", (6, 6)),
                            ("fc8", (5, 6))):
            sd[name + ".weight"] = torch.randn(*shape, generator=g)
            sd[name + ".bias"] = torch.randn(shape[0], generator=g)
        torch.save(sd, path)


@pytest.mark.parametrize("kind,network", [
    ("torchvision", "r2plus1d_18"), ("torchvision", "mc3_18"),
    ("c3d", "c3d"), ("reference", "r3d_18")])
def test_port_checkpoint_matches_jax(tmp_path, capsys, kind, network):
    """The same npz as the JAX tool's (members, shapes, dtypes, values,
    __step__ and __meta__ up to the output path) and the same line; a
    torchvision or C3D source gives the backbone only. Each package's
    warm_start loads the other package's file as its own (the C3D file's
    small widths load into no model, and are held by value only)."""
    src = str(tmp_path / {"c3d": "c3d.pickle",
                          "reference": "checkpoint.pth.tar"}.get(
                              kind, f"{network}.pth"))
    _source(kind, network, src)
    outs = [str(tmp_path / who / f"{network}.npz") for who in ("port", "jax")]
    got, want = _run_both(
        port_checkpoint.main, jax_port.main,
        ["--src", src, "--network", network, "--out", outs[0]],
        ["--src", src, "--network", network, "--out", outs[1]], capsys)
    assert got == f"ported {src} ({kind}) -> {outs[0]}\n"
    assert got.replace(outs[0], outs[1]) == want
    z = _same_npz(*outs)
    meta = json.loads(str(z["__meta__"]))
    assert meta == {"epoch": -1, "accuracy": 0.0,
                    "ported_from": f"{kind}:{src}"}
    heads = [k for k in z if k.startswith("params::head/")]
    assert bool(heads) == (kind == "reference")
    if kind == "c3d":
        return
    import jax

    from zeroshotvideoclassification_tpu.config import Config as JaxConfig
    from zeroshotvideoclassification_tpu.models import (
        get_network as jax_network,
    )
    from zeroshotvideoclassification_tpu.train import (
        warm_start as jax_warm_start,
    )

    loaded = []
    for path in outs:
        m = _seeded(network, seed=11)
        n = warm_start(path, m)
        loaded.append((n, m.state_dict()))
    (n0, a), (n1, b) = loaded
    assert n0 == n1 == len([k for k in z if "::" in k])
    for k in a:
        assert torch.equal(a[k], b[k]), k
    jm = jax_network(JaxConfig(network=network, head="mlp"))
    fp, fs = jax.jit(jm.init)(jax.random.PRNGKey(0))
    trees = [jax_warm_start(path, fp, fs, network=network)
             for path in outs]
    assert trees[0][2] == trees[1][2] == n0
    for x, y in zip(jax.tree.leaves(trees[0][:2]),
                    jax.tree.leaves(trees[1][:2])):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    for f in outs:
        os.unlink(f)
    os.unlink(src)


def test_port_checkpoint_of_another_network_raises_like_jax(tmp_path):
    """A torchvision r3d_18 file asked for as r2plus1d_18: both tools raise
    KeyError and write nothing."""
    src = str(tmp_path / "r3d_18.pth")
    _source("torchvision", "r3d_18", src)
    for fn, out in ((port_checkpoint.port_checkpoint, "port.npz"),
                    (jax_port.port_checkpoint, "jax.npz")):
        with pytest.raises(KeyError):
            fn(src, "r2plus1d_18", "mlp", str(tmp_path / out))
        assert not (tmp_path / out).exists()


# ------------------------------------------------------- extract_captions --

def test_extract_captions_without_transformers(tmp_path, monkeypatch):
    """transformers blocked: both tools exit with the same message, before
    any folder is read (no weights are in the repository)."""
    monkeypatch.setenv("HF_HUB_OFFLINE", "1")
    monkeypatch.setitem(sys.modules, "transformers", None)
    argv = ["--frames_root", str(tmp_path)]
    with pytest.raises(SystemExit) as got:
        extract_captions.main(argv)
    with pytest.raises(SystemExit) as want:
        jax_captions.main(argv)
    assert str(got.value) == str(want.value)
    assert str(got.value).startswith(
        "captioning needs transformers+torch with weights: ")
