"""The port's model against the JAX package's: the weight bridge round trip
through models/porting.py, the full-depth forward in float32, the bf16
forward, cosine distances, and the strict npz checkpoint reader. Weights
come from the JAX init with numpy-randomized BatchNorm statistics, so every
epilogue does real work."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zeroshotvideoclassification_tpu.config import Config
from zeroshotvideoclassification_tpu.models import get_network as jax_network
from zeroshotvideoclassification_tpu.models.porting import _port_reference_sd
from zeroshotvideoclassification_tpu.ops.cdist import (
    cosine_distances as jax_cosine_distances,
)
from zeroshotvideoclassification_tpu_torch.models import bridge, get_network
from zeroshotvideoclassification_tpu_torch.ops.cdist import cosine_distances
from zeroshotvideoclassification_tpu_torch.train import (
    eval_step,
    load_checkpoint,
)

ARCHS = ["r2plus1d_18", "r3d_18", "mc3_18"]


def randomize_bn(params, state, rng):
    """Random BN scale/bias and running mean/var (in place, numpy)."""
    for k, v in params.items():
        if not isinstance(v, dict):
            continue
        if set(v) == {"scale", "bias"}:
            c = v["scale"].shape[0]
            v["scale"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
            v["bias"] = rng.normal(0, 0.2, c).astype(np.float32)
            state[k]["mean"] = rng.normal(0, 0.2, c).astype(np.float32)
            state[k]["var"] = rng.uniform(0.5, 2.0, c).astype(np.float32)
        elif k in state:
            randomize_bn(v, state[k], rng)


def jax_weights(arch, seed=0):
    """(JAX model, params, model_state) as writable numpy trees."""
    model = jax_network(Config(network=arch, head="mlp"))
    params, state = jax.jit(model.init)(jax.random.PRNGKey(seed))
    params = jax.tree.map(np.array, params)
    state = jax.tree.map(np.array, state)
    randomize_bn(params, state, np.random.default_rng(seed))
    return model, params, state


def port_model(arch, params, state, dtype=torch.float32):
    m = get_network(Config(network=arch, head="mlp"))
    m.load_state_dict(bridge.from_jax(params, state), strict=True)
    m.set_compute_dtype(dtype)
    return m.to(memory_format=torch.channels_last_3d).eval()


def _trees_equal(a, b):
    return jax.tree.all(jax.tree.map(np.array_equal, a, b))


@pytest.mark.parametrize("arch", ARCHS)
def test_bridge_round_trip_through_porting(arch):
    """JAX init -> bridge.from_jax -> port state_dict ->
    porting._port_reference_sd gives back the JAX trees exactly."""
    _, params, state = jax_weights(arch)
    m = port_model(arch, params, state)
    sd = {k: v.numpy() for k, v in m.state_dict().items()}
    p2, s2 = _port_reference_sd(sd, arch, "mlp")
    assert jax.tree.structure(p2) == jax.tree.structure(params)
    assert _trees_equal(p2, params) and _trees_equal(s2, state)


def test_state_dict_uses_reference_key_names():
    keys = set(get_network(Config(network="r2plus1d_18")).state_dict())
    for k in ("model.stem.0.weight", "model.stem.1.running_var",
              "model.stem.3.weight", "model.stem.4.bias",
              "model.layer1.0.conv1.0.0.weight",
              "model.layer1.0.conv1.0.1.running_mean",
              "model.layer1.0.conv1.0.3.weight",
              "model.layer1.0.conv1.1.weight",
              "model.layer2.0.conv2.1.num_batches_tracked",
              "model.layer4.0.downsample.0.weight",
              "model.layer4.0.downsample.1.running_var",
              "output2emb_proj.layers.0.weight",
              "output2emb_proj.layers.1.bias"):
        assert k in keys, k
    assert not any("layer1.0.downsample" in k for k in keys)


@pytest.mark.parametrize("arch", ARCHS)
def test_full_network_matches_jax_f32(arch):
    model, params, state = jax_weights(arch, seed=1)
    x = np.random.default_rng(7).uniform(
        -0.5, 0, (2, 2, 4, 32, 32, 3)).astype(np.float32)
    want, _ = jax.jit(lambda p, s, xx: model.apply(
        p, s, xx, train=False, compute_dtype=jnp.float32))(params, state, x)
    got = eval_step(port_model(arch, params, state), torch.from_numpy(x))
    assert got.dtype == torch.float32 and tuple(got.shape) == (2, 300)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-4)
    np.testing.assert_allclose(np.linalg.norm(got.numpy(), axis=-1), 1.0,
                               atol=1e-5)


def test_bf16_forward_tracks_jax_bf16():
    """bf16 convs on both sides. They round at different places (the JAX
    default path rounds after BN and again after the residual add, K2 once;
    the conv libraries accumulate differently), so the bar is per-row cosine
    similarity, not elementwise."""
    model, params, state = jax_weights("r2plus1d_18", seed=2)
    x = np.random.default_rng(8).uniform(
        -0.5, 0, (2, 2, 4, 32, 32, 3)).astype(np.float32)
    want, _ = jax.jit(lambda p, s, xx: model.apply(
        p, s, xx, train=False, compute_dtype=jnp.bfloat16))(params, state, x)
    m = port_model("r2plus1d_18", params, state, torch.bfloat16)
    got = eval_step(m, torch.from_numpy(x).bfloat16()).numpy()
    want = np.asarray(want)
    cos = (got * want).sum(-1) / (np.linalg.norm(got, axis=-1)
                                  * np.linalg.norm(want, axis=-1))
    assert cos.min() > 0.999, cos


def test_cosine_distances_match_jax(rng):
    a = rng.normal(size=(5, 300)).astype(np.float32)
    b = rng.normal(size=(7, 300)).astype(np.float32)
    want = np.asarray(jax_cosine_distances(a, b))
    got = cosine_distances(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)


def test_bridge_rejects_leaves_without_counterpart():
    with pytest.raises(ValueError, match="no counterpart"):
        bridge.from_flat({"backbone/conv1/w": np.zeros((3, 3, 3, 3, 8))}, {})
    with pytest.raises(ValueError, match="no counterpart"):
        bridge.from_flat({"head/regressor/w": np.zeros((512, 300))}, {})


def test_unported_heads_raise():
    with pytest.raises(ValueError, match="not ported"):
        get_network(Config(network="r2plus1d_18", head="linear"))
    with pytest.raises(ValueError, match="not ported"):
        get_network(Config(network="c3d"))


def _save_jax_checkpoint(path, params, state):
    from zeroshotvideoclassification_tpu.train import (
        make_optimizer,
        save_checkpoint,
    )
    from zeroshotvideoclassification_tpu.train.step import TrainState

    ts = TrainState(params=params, model_state=state,
                    opt_state=make_optimizer(1e-3).init(params),
                    step=jnp.zeros((), jnp.int32))
    save_checkpoint(str(path), ts, epoch=3, accuracy=12.5)


def test_checkpoint_strict_load(tmp_path):
    _, params, state = jax_weights("r2plus1d_18", seed=3)
    path = tmp_path / "ckpt.npz"
    _save_jax_checkpoint(path, params, state)
    m = get_network(Config(network="r2plus1d_18"))
    meta = load_checkpoint(str(path), m)
    assert meta["epoch"] == 3 and meta["accuracy"] == 12.5
    want = bridge.from_jax(params, state)
    got = m.state_dict()
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k

    # another network's checkpoint is refused, and leaves the model as it was
    _, p3, s3 = jax_weights("r3d_18", seed=4)
    other = tmp_path / "r3d.npz"
    _save_jax_checkpoint(other, p3, s3)
    with pytest.raises(ValueError, match="does not match"):
        load_checkpoint(str(other), m)
    assert torch.equal(m.state_dict()["model.stem.0.weight"],
                       want["model.stem.0.weight"])

    # a missing tensor is refused
    with np.load(path) as z:
        kept = {k: z[k] for k in z.files
                if k != "model_state::backbone/layer3_1/bn2/var"}
    partial = tmp_path / "partial.npz"
    np.savez(partial, **kept)
    with pytest.raises(ValueError, match="does not match"):
        load_checkpoint(str(partial), get_network(
            Config(network="r2plus1d_18")))
