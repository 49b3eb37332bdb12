"""The port's C3D against the JAX package's, on the CPU at the model's own
size (fc6 fixes the input at 16 x 112 x 112): the backbone's float32
forward (batch 1, the bar of JAX tests/test_models.py:147), the whole model
with its head at two clips, two f32 train steps, the bridge round trip in
the reference's layout (conv1 ... fc6 and regressor at the top level), the
casts of serving and of training, and the init (its checkpoints and warm
starts: test_torch_weights.py). Weights: a seeded He init
(torch_helpers.calibrate_c3d: under the default init the features hardly
depend on the clip)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as TF

from zeroshotvideoclassification_tpu.config import Config
from zeroshotvideoclassification_tpu.models import get_network as jax_network
from zeroshotvideoclassification_tpu.models.porting import _port_reference_sd
from zeroshotvideoclassification_tpu_torch.cli.infer import load_model
from zeroshotvideoclassification_tpu_torch.config import Config as PortConfig
from zeroshotvideoclassification_tpu_torch.models import bridge, get_network
from zeroshotvideoclassification_tpu_torch.models.c3d import CONVS
from zeroshotvideoclassification_tpu_torch.models.layers import init_weights
from zeroshotvideoclassification_tpu_torch.train import (
    eval_step,
    make_optimizer,
    make_train_step,
)

from test_torch_train import (
    as_torch,
    assert_trees_close,
    jax_steps,
    seeded_moments,
)
from torch_helpers import calibrate_c3d

CLIP = (16, 112, 112, 3)


@pytest.fixture(autouse=True)
def grad_enabled():
    """Another test module switches autograd off for its whole process when
    it is imported; the tests here differentiate."""
    with torch.enable_grad():
        yield


def _x(shape, seed):
    return np.random.default_rng(seed).uniform(-0.5, 0, shape).astype(
        np.float32)


@pytest.fixture(scope="module")
def c3d():
    """(JAX model, params) of C3D + its head, He-initialised, numpy."""
    port = get_network(PortConfig(network="c3d"))
    init_weights(port, torch.Generator().manual_seed(0))
    calibrate_c3d(port, seed=1)
    params, _ = bridge.to_jax(port.state_dict())
    return jax_network(Config(network="c3d")), params


def port_c3d(params, dtype=torch.float32):
    m = get_network(PortConfig(network="c3d"))
    m.load_state_dict(bridge.from_jax(params, {}), strict=True)
    m.set_compute_dtype(dtype)
    return m.to(memory_format=torch.channels_last_3d)


def test_c3d_backbone_matches_jax_f32(c3d):
    """One clip through JAX C3DBackbone and the port's C3D: fc6 features
    [1, 4096] within atol 3e-4 / rtol 1e-4, and the features do depend on
    the clip (the conv stack's signal reaches fc6)."""
    model, params = c3d
    x = _x((2, *CLIP), 2)
    want, featmap, _ = jax.jit(lambda p, xx: model.backbone.apply(
        p, {}, xx, train=False, compute_dtype=jnp.float32))(
        params["backbone"], x[:1])
    assert featmap.shape == (1, 1, 4, 4, 512)
    bb = port_c3d(params).backbone
    xt = torch.from_numpy(x).permute(0, 4, 1, 2, 3)
    with torch.inference_mode():
        got = bb(xt[:1])
        other = bb(xt[1:])
    assert got.dtype == torch.float32 and tuple(got.shape) == (1, 4096)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=3e-4,
                               rtol=1e-4)
    # two noise clips: 5.4e-2 apart relative (2.1e-3 under the default
    # init, where the biases set the features)
    assert float((other - got).norm() / got.norm()) > 2e-2


def test_c3d_head_matches_jax_at_two_clips(c3d):
    """The whole model, eval mode (dropout inactive), one video of two
    different clips: the head averages relu(fc6) over the clips, then the
    regressor; unit embeddings within 1e-4."""
    model, params = c3d
    x = _x((1, 2, *CLIP), 3)
    want, _ = jax.jit(lambda p, xx: model.apply(
        p, {"backbone": {}}, xx, train=False, compute_dtype=jnp.float32))(
        params, x)
    got = eval_step(port_c3d(params).eval(), torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-4)


def test_c3d_train_steps_match_jax(c3d):
    """Two f32 steps at batch 1, dropout at rate 0 on both sides, from the
    same seeded non-zero Adam state: loss rtol 1e-4, parameters atol 2e-5
    (as test_torch_train.test_train_steps_match_jax)."""
    model, params = c3d
    model = dataclasses.replace(model, dropout_rate=0.0)
    rng = np.random.default_rng(4)
    ce = rng.normal(size=(3, 300)).astype(np.float32)
    ce /= np.linalg.norm(ce, axis=1, keepdims=True)
    data = [(_x((1, 1, *CLIP), 5 + i), ce[[i]], np.asarray([i], np.int32),
             np.ones(1, np.float32)) for i in range(2)]
    moments = seeded_moments(params, 6)
    ts, want = jax_steps(model, params, {"backbone": {}}, data, ce, 1e-3,
                         moments, 1000)
    m = port_c3d(params)
    assert (m.head, m.dropout_rate) == ("c3d", 0.1)
    m.dropout_rate = 0.0
    opt = make_optimizer(m.parameters(), 1e-3)
    bridge.adam_from_jax(m, opt, *moments, 1000)
    step = make_train_step(m, opt, compute_dtype=torch.float32)
    got = [float(step(*as_torch(*d, ce))["loss"]) for d in data]
    np.testing.assert_allclose(got, [w[0] for w in want], rtol=1e-4)
    assert_trees_close(bridge.to_jax(m.state_dict())[0],
                       jax.tree.map(np.asarray, ts.params), atol=2e-5)


def test_c3d_bridge_round_trip_through_porting(c3d):
    """JAX tree -> bridge.from_jax -> the port's state_dict, in the
    reference's layout -> porting._port_reference_sd(sd, 'c3d', 'c3d')
    gives back the tree; fc6 crosses as a plain transpose."""
    _, params = c3d
    sd = {k: v.numpy() for k, v in port_c3d(params).state_dict().items()}
    assert sorted(sd) == sorted(
        [f"{n}.{w}" for n, _, _ in CONVS for w in ("weight", "bias")]
        + ["fc6.weight", "fc6.bias", "regressor.weight", "regressor.bias"])
    np.testing.assert_array_equal(sd["fc6.weight"],
                                  params["backbone"]["fc6"]["w"].T)
    p2, s2 = _port_reference_sd(sd, "c3d", "c3d")
    assert s2 == {"backbone": {}}
    assert jax.tree.structure(p2) == jax.tree.structure(params)
    assert jax.tree.all(jax.tree.map(np.array_equal, p2, params))


def test_c3d_casts_for_serving_and_training():
    """Serving in bf16 casts the convs' weights AND biases once, fc6 and
    the head stay float32; training keeps float32 masters, and a conv adds
    its bias after the bf16 conv, in bf16 (layers.py:118-119)."""
    cfg = PortConfig(network="c3d", compute_dtype="bfloat16")
    served, _ = load_model(cfg, None, "cpu")
    for name, _, _ in CONVS:
        conv = getattr(served, name)
        assert conv.weight.dtype == conv.bias.dtype == torch.bfloat16, name
    assert served.fc6.weight.dtype == served.regressor.bias.dtype == (
        torch.float32)
    m = get_network(cfg)
    init_weights(m, torch.Generator().manual_seed(3))
    m.set_compute_dtype(torch.bfloat16, masters=True)
    conv = m.conv3a
    assert conv.weight.dtype == conv.bias.dtype == torch.float32
    x = torch.rand(1, 128, 2, 6, 6) - 0.5
    got = conv(x)
    want = TF.conv3d(x.bfloat16(), conv.weight.bfloat16(), None, 1, 1)
    want = want + conv.bias.bfloat16().view(-1, 1, 1, 1)
    assert got.dtype == torch.bfloat16 and torch.equal(got, want)


def test_c3d_init_is_torchs_default():
    """init_weights gives C3D's convs U(+-1/sqrt(fan_in)) weights and
    biases (JAX c3d.py:37-49), fc6 and the head the linear rule."""
    m = get_network(PortConfig(network="c3d"))
    init_weights(m, torch.Generator().manual_seed(0))
    for name, cin, _ in CONVS + (("fc6", 8192, 0),):
        layer = getattr(m, name)
        bound = 1.0 / np.sqrt(cin * (27 if name != "fc6" else 1))
        for t in (layer.weight.detach(), layer.bias.detach()):
            assert float(t.abs().max()) <= bound, name
        w = layer.weight.detach()
        assert float(w.abs().max()) > 0.99 * bound, name
        assert abs(float(w.std()) - bound / np.sqrt(3)) < 0.02 * bound, name
