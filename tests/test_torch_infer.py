"""The port's one-shot inference CLI held to the JAX package's: the JAX
cli/infer.classify_videos (called with a namespace that carries
decode_scale=1, which its flag parser would add) and the port's, on the
same seeded .npy clips and the same npz weights, in float32, rank the
classes alike: equal top-k classes, similarities within 1e-4. For
r2plus1d_18 + mlp (2 clips of 4 x 32 x 32 a video) and for C3D (one clip
of 16 x 112 x 112, which fc6 fixes). And a caller's clip_pool reaches the
model of the CLI and of the engine."""

import argparse

import numpy as np
import pytest
import torch

from zeroshotvideoclassification_tpu.cli.infer import (
    classify_videos as jax_classify_videos,
)
from zeroshotvideoclassification_tpu.models.porting import save_ported_npz
from zeroshotvideoclassification_tpu.text import classes2embedding
from zeroshotvideoclassification_tpu.text.word2vec import SyntheticWordVectors
from zeroshotvideoclassification_tpu_torch.cli.infer import classify_videos
from zeroshotvideoclassification_tpu_torch.config import Config as PortConfig
from zeroshotvideoclassification_tpu_torch.models import bridge, get_network
from zeroshotvideoclassification_tpu_torch.models.layers import init_weights

from test_torch_model import jax_weights
from test_torch_serve import CLASSES, _assert_same_results
from torch_helpers import calibrate_c3d, remove_large_files, synthetic_clip

CASES = {  # network: (n_clips, clip_len, size, videos)
    "r2plus1d_18": (2, 4, 32, 5),
    "c3d": (1, 16, 112, 2),
}


@pytest.fixture(autouse=True)
def drop_large_files(tmp_path):
    """Delete the test's large files when it ends
    (torch_helpers.remove_large_files)."""
    yield
    remove_large_files(tmp_path)


def _weights(network, path):
    """Seeded weights of `network` + its head as an npz of the JAX
    package's layout (params and BN statistics only)."""
    if network == "c3d":
        m = get_network(PortConfig(network="c3d"))
        init_weights(m, torch.Generator().manual_seed(0))
        calibrate_c3d(m, seed=2)
        params, state = bridge.to_jax(m.state_dict())
        state = {"backbone": {}}
    else:
        _, params, state = jax_weights(network, seed=5)
    save_ported_npz(str(path), params, state, source="test")


@pytest.mark.parametrize("network", sorted(CASES))
def test_port_cli_ranks_as_the_jax_cli(network, tmp_path):
    n_clips, clip_len, size, n = CASES[network]
    paths = []
    for i in range(n):
        p = tmp_path / f"clip{i}.npy"
        np.save(p, synthetic_clip(10 + i, 3 * clip_len, 2 * size,
                                  2 * size + 20))
        paths.append(str(p))
    weights = tmp_path / "weights.npz"
    _weights(network, weights)
    class_embed = classes2embedding("kinetics", CLASSES,
                                    SyntheticWordVectors())
    args = argparse.Namespace(
        network=network, head="mlp", weights=str(weights), n_clips=n_clips,
        clip_len=clip_len, size=size, bs=4, top_k=3,
        compute_dtype="float32", decode_scale=1, device="cpu")
    want = jax_classify_videos(paths, CLASSES, class_embed, args)
    got = classify_videos(paths, CLASSES, class_embed, args)
    assert all("top_class" in r for r in want)
    _assert_same_results(got, want)
    # the clips are ranked apart (the check above is not trivially met)
    assert len({tuple(t["similarity"] for t in r["topk"])
                for r in got}) == n


def test_clip_pool_reaches_the_served_model(monkeypatch):
    """The JAX CLIs have no --clip_pool flag (the port's keep their flags);
    a caller's namespace or the engine's keyword picks the model's clip
    pooling, 'feature' when absent."""
    from zeroshotvideoclassification_tpu_torch.cli import infer
    from zeroshotvideoclassification_tpu_torch.serve import InferenceEngine

    engine = InferenceEngine(CLASSES, np.eye(4, 300, dtype=np.float32),
                             n_clips=2, clip_len=4, size=32, max_batch=4,
                             compute_dtype="float32", device="cpu",
                             clip_pool="embedding")
    engine.close()
    assert engine.model.clip_pool == "embedding"
    seen = []

    def scoring_state(config, weights, device):
        seen.append(config.clip_pool)
        raise StopIteration

    monkeypatch.setattr(infer, "build_scoring_state", scoring_state)
    args = argparse.Namespace(
        network="r2plus1d_18", head="mlp", weights="none", n_clips=2,
        clip_len=4, size=32, bs=4, top_k=3, compute_dtype="float32",
        device="cpu")
    for pool in ("embedding", None):
        if pool:
            args.clip_pool = pool
        else:
            del args.clip_pool
        with pytest.raises(StopIteration):
            classify_videos([], CLASSES, np.eye(4, 300), args)
    assert seen == ["embedding", "feature"]
