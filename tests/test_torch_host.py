"""The port's own copy of the host side against the JAX package's, on the
CPU from the same seeds: the synthetic datasets, HostPipeline batches byte
for byte, class-name embedding, Config and the argument parsers. The two
packages share no host code; these tests keep the copies from drifting."""

import argparse
import dataclasses

import numpy as np
import pytest

from zeroshotvideoclassification_tpu import config as jax_config
from zeroshotvideoclassification_tpu.cli import infer as jax_infer
from zeroshotvideoclassification_tpu.cli import serve as jax_serve
from zeroshotvideoclassification_tpu.data.pipeline import (
    HostPipeline as JaxHostPipeline,
)
from zeroshotvideoclassification_tpu.data.synthetic import (
    build_synthetic_datasets as jax_synthetic,
)
from zeroshotvideoclassification_tpu_torch import config as port_config
from zeroshotvideoclassification_tpu_torch.cli import infer as port_infer
from zeroshotvideoclassification_tpu_torch.cli import main as port_main
from zeroshotvideoclassification_tpu_torch.cli import serve as port_serve
from zeroshotvideoclassification_tpu_torch.data.pipeline import HostPipeline
from zeroshotvideoclassification_tpu_torch.data.synthetic import (
    build_synthetic_datasets,
)

FIELDS = ("canvas", "y0", "y1", "wy", "x0", "x1", "wx", "z", "label",
          "weight")
SMALL = dict(dataset="synthetic", class_total=6, train_samples=14, bs=4,
             clip_len=4, n_clips=2, size=32, canvas_hw=(64, 86),
             decode_workers=2, prefetch_depth=0)


@pytest.mark.parametrize("split,seed", [("training", 0), ("training", 7),
                                        ("testing", 0)])
def test_host_pipeline_batches_are_byte_identical(split, seed):
    """Same config, same seed: every array of every batch of the synthetic
    train (random TSN starts, crops, flips) and validation tables."""
    want_t = jax_synthetic(jax_config.Config(**SMALL))[split][0]
    got_t = build_synthetic_datasets(port_config.Config(**SMALL))[split][0]
    assert got_t.name == want_t.name and got_t.classes == want_t.classes
    assert got_t.is_validation == want_t.is_validation
    assert got_t.n_clips == want_t.n_clips and got_t.loader == "synthetic"
    np.testing.assert_array_equal(got_t.label_idx, want_t.label_idx)
    np.testing.assert_array_equal(got_t.class_embed, want_t.class_embed)
    want = list(JaxHostPipeline(want_t, jax_config.Config(**SMALL), 5,
                                seed=seed))
    got = list(HostPipeline(got_t, port_config.Config(**SMALL), 5, seed=seed))
    assert len(got) == len(want) > 1
    for g, w in zip(got, want):
        assert g.image_mode == w.image_mode is False
        for f in FIELDS:
            a, b = getattr(g, f), getattr(w, f)
            assert a.dtype == b.dtype and a.shape == b.shape, f
            assert a.tobytes() == b.tobytes(), f
    assert got[0].canvas.dtype == np.uint8 and got[0].canvas.any()
    assert got[-1].weight.min() == 0.0  # the zero-weight-padded last batch


def _class_args(**kw):
    base = dict(classes=["playing guitar", "riding a horse", "washing dishes"],
                classes_file=None, class_rule="kinetics", class_embed=None,
                synthetic_word2vec=True, word2vec_path="", word2vec_cache="")
    base.update(kw)
    return argparse.Namespace(**base)


@pytest.mark.parametrize("rule,names", [
    ("kinetics", ["playing guitar", "riding a horse", "washing dishes"]),
    ("ucf101", ["ApplyEyeMakeup", "HorseRiding", "YoYo"]),
    ("hmdb51", ["brush_hair", "ride_horse", "shoot_bow"]),
    ("activitynet", ["Playing guitarra", "Horseback riding", "Washing face"]),
    ("sun", ["abbey", "airport_terminal", "living_room"])])
def test_resolve_classes_matches(rule, names, tmp_path):
    names_file = tmp_path / "names.txt"
    names_file.write_text("\n\n".join(names[1:]) + "\n")
    args = _class_args(class_rule=rule, classes=names[:1],
                       classes_file=str(names_file))
    want_names, want = jax_infer.resolve_classes(args)
    got_names, got = port_infer.resolve_classes(args)
    assert got_names == want_names == names
    np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, atol=1e-5)


def test_resolve_classes_from_a_precomputed_file_matches(tmp_path):
    rng = np.random.default_rng(0)
    path = tmp_path / "ce.npz"
    np.savez(path, classes=np.asarray(["a", "b"]),
             embeddings=rng.normal(size=(2, 300)).astype(np.float32))
    args = _class_args(class_embed=str(path))
    want_names, want = jax_infer.resolve_classes(args)
    got_names, got = port_infer.resolve_classes(args)
    assert got_names == want_names == ["a", "b"]
    np.testing.assert_array_equal(got, want)
    with pytest.raises(SystemExit):
        port_infer.resolve_classes(_class_args(classes=None))


def test_config_defaults_match_field_by_field():
    want = dataclasses.asdict(jax_config.Config())
    got = dataclasses.asdict(port_config.Config())
    assert list(got) == list(want)
    for k in want:
        assert got[k] == want[k], k
    a, b = port_config.Config(), jax_config.Config()
    assert a.savename(1) == b.savename(1) and a.to_json() == b.to_json()
    assert a.eval_n_clips == b.eval_n_clips
    assert (port_config.Config.from_json(b.to_json()) == a)
    assert not hasattr(port_config, "compute_jnp_dtype")


@pytest.mark.parametrize("argv", [
    [],
    ["--dataset", "synthetic", "--bs", "16", "--lr", "1e-4", "--n_epochs",
     "20", "--compute_dtype", "float32", "--canvas_hw", "128", "171"],
    ["--tp", "2", "--remat", "--no-progressbar", "--evaluate", "--split", "3",
     "--no-h2d_window", "--decode_scale", "4", "--nopretrained",
     "--fixconvs", "--class_total", "10", "--train_samples", "100"],
])
def test_config_from_args_matches_field_by_field(argv):
    want = dataclasses.asdict(jax_config.config_from_args(argv))
    got = dataclasses.asdict(port_config.config_from_args(argv))
    assert got == want
    cfg = port_config.config_from_args(argv)
    assert cfg.savename(1) == jax_config.config_from_args(argv).savename(1)


def _flags(parser):
    return {s: (type(a).__name__, a.default, a.nargs,
                None if a.choices is None else tuple(a.choices))
            for a in parser._actions for s in a.option_strings}


def test_parsers_accept_the_same_flags():
    """Flag for flag, with the same defaults, arity and choices; the port's
    entry points add --device and nothing else."""
    assert _flags(port_config.build_arg_parser()) == _flags(
        jax_config.build_arg_parser())
    train = _flags(port_main.build_arg_parser())
    assert set(train) - set(_flags(jax_config.build_arg_parser())) == {
        "--device"}
    assert train["--device"][1] == "cuda"

    want, got = argparse.ArgumentParser(), argparse.ArgumentParser()
    jax_infer.add_class_and_model_args(want)
    port_infer.add_class_and_model_args(got)
    assert _flags(got) == _flags(want)

    serve, jserve = (_flags(port_serve.build_arg_parser()),
                     _flags(jax_serve.build_arg_parser()))
    assert set(serve) - set(jserve) == {"--device"}
    assert {k: v for k, v in serve.items() if k != "--device"} == jserve
    infer = _flags(port_infer.build_arg_parser())
    assert set(infer) - set(_flags(want)) == {"--videos", "--device"}
