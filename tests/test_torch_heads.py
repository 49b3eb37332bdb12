"""The port's heads and backbone options against the JAX package's, on the
CPU at small sizes: get_network's routing, the linear head and
clip_pool='embedding' (forward at two clips), dropout, fixconvs, remat
(loss, gradients and BN running statistics against the plain step and the
JAX package's), f32 train steps of r3d_18 + the linear head, the bridge
round trip of the linear head's tree, and the trainer's epoch with these
flags (their checkpoints: test_torch_weights.py). Inputs and weights come
from numpy seeds; the JAX side runs its default (plain XLA) BN path."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from zeroshotvideoclassification_tpu.config import Config
from zeroshotvideoclassification_tpu.models import get_network as jax_network
from zeroshotvideoclassification_tpu.models import layers as JL
from zeroshotvideoclassification_tpu.models.porting import _port_reference_sd
from zeroshotvideoclassification_tpu_torch.cli import main as port_main
from zeroshotvideoclassification_tpu_torch.config import Config as PortConfig
from zeroshotvideoclassification_tpu_torch.models import bridge, get_network
from zeroshotvideoclassification_tpu_torch.models import layers as PL
from zeroshotvideoclassification_tpu_torch.train import (
    eval_step,
    make_optimizer,
    make_train_step,
)

from test_torch_train import (
    as_torch,
    assert_trees_close,
    batches,
    jax_leaf_shapes,
    jax_steps,
    jax_weights,
    port_model,
    seeded_moments,
)
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
    it is imported; the tests here differentiate."""
    with torch.enable_grad():
        yield


def _x(shape, seed):
    return np.random.default_rng(seed).uniform(-0.5, 0, shape).astype(
        np.float32)


# ------------------------------------------------------------ routing -------

@pytest.mark.parametrize("cfg", [
    dict(network="r2plus1d_18"), dict(network="mc3_18"),
    dict(network="r3d_18"), dict(network="resnet18"),
    dict(network="resnet18", head="mlp"), dict(network="c3d"),
    dict(network="c3d", head="linear", clip_pool="embedding"),
    dict(network="c3d", remat="full"), dict(network="c3d", remat=True),
    dict(network="r3d_18", head="linear"),
    dict(network="r2plus1d_18", remat="none"),
    dict(network="r2plus1d_18", remat=True),
    dict(network="r3d_18", remat="convs"),
    dict(network="mc3_18", clip_pool="embedding", fixconvs=True)])
def test_get_network_routes_as_jax(cfg, capsys):
    """The same substring routing as the JAX get_network: backbone, head,
    dropout, clip pooling, frozen convs, remat ('none' is off; on C3D the
    same warning on stderr and no effect) and the same tensors under the
    bridge's names."""
    jm = jax_network(Config(**cfg))
    jax_err = capsys.readouterr().err
    with torch.device("meta"):
        pm = get_network(PortConfig(**cfg))
    assert capsys.readouterr().err == jax_err
    assert ("has no effect" in jax_err) == (cfg["network"] == "c3d"
                                            and bool(cfg.get("remat")))
    assert (pm.head, pm.fixconvs, pm.clip_pool) == (jm.head, jm.fixconvs,
                                                    jm.clip_pool)
    assert pm.dropout_rate == pytest.approx(jm.dropout_rate)
    assert type(pm.backbone).__name__ == {
        "C3DBackbone": "C3D"}.get(type(jm.backbone).__name__,
                                  type(jm.backbone).__name__)
    assert getattr(pm.backbone, "remat", False) == getattr(
        jm.backbone, "remat", False)
    got = {k: tuple(v.shape) for k, v in pm.state_dict().items()
           if not k.endswith("num_batches_tracked")}
    assert got == jax_leaf_shapes(jm)


def test_get_network_refuses_unknown_networks():
    for get in (jax_network, get_network):
        with pytest.raises(ValueError, match="not available"):
            get(Config(network="vgg"))


# ---------------------------------------------- heads and clip pooling ------

@pytest.mark.parametrize("net,head,clip_pool", [
    ("r3d_18", "linear", "feature"), ("resnet18", "linear", "embedding"),
    ("r2plus1d_18", "mlp", "embedding")])
def test_heads_match_jax_at_two_clips(net, head, clip_pool):
    """Eval-mode forward of 2 videos x 2 different clips in float32 (the
    linear head's dropout present and inactive), at the bar of
    test_torch_model.test_full_network_matches_jax_f32; 'embedding' differs
    from 'feature' on the same weights, so the per-clip head is really
    run."""
    arch = "r3d_18" if net == "resnet18" else net
    model, params, state = jax_weights(arch, seed=1, head=head,
                                       clip_pool=clip_pool)
    model = jax_network(Config(network=net, head=head, clip_pool=clip_pool))
    x = _x((2, 2, 4, 32, 32, 3), 7)
    want, _ = jax.jit(lambda p, s, xx: model.apply(
        p, s, xx, train=False, compute_dtype=jnp.float32))(params, state, x)
    m = port_model(params, state, net, head=head, clip_pool=clip_pool)
    assert (m.head, m.clip_pool) == (model.head, model.clip_pool)
    got = eval_step(m.eval(), torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-4)
    m.clip_pool = "embedding" if clip_pool == "feature" else "feature"
    other = eval_step(m, torch.from_numpy(x))
    assert float((other - got).abs().max()) > 1e-3


# ------------------------------------------------------------ dropout -------

@pytest.mark.parametrize("rate", [0.05, 0.1, 0.5])
def test_dropout_keeps_its_share_and_scales(rate):
    """Kept share within 4 sigma of 1 - rate, kept values x / keep and the
    rest 0, the input's dtype, one mask per generator seed."""
    x = torch.rand(1 << 18) + 0.5
    keep = 1.0 - rate

    def drop(seed, xx=x):
        return PL.dropout(xx, rate, torch.Generator().manual_seed(seed), True)

    y = drop(0)
    kept = y != 0
    sigma = (keep * rate / x.numel()) ** 0.5
    assert abs(float(kept.float().mean()) - keep) < 4 * sigma
    assert torch.equal(y[kept], x[kept] / keep)
    assert torch.equal(drop(0), y) and not torch.equal(drop(1), y)
    yb = drop(0, x.bfloat16())
    assert yb.dtype == torch.bfloat16 and torch.equal(yb != 0, kept)


def test_dropout_is_the_identity_where_jax_is():
    """Eval mode, rate 0 and no generator: the input itself on both sides,
    so the heads' forward and rate-0 train steps hold exactly."""
    x = _x((4, 512), 3)
    xt, g = torch.from_numpy(x), torch.Generator().manual_seed(0)
    key = jax.random.PRNGKey(0)
    for rate, rng, train in ((0.05, g, False), (0.0, g, True),
                             (0.1, None, True)):
        assert PL.dropout(xt, rate, rng, train) is xt
        jrng = None if rng is None else key
        np.testing.assert_array_equal(
            np.asarray(JL.dropout(jnp.asarray(x), rate, jrng, train)), x)


# ------------------------------------------------------------ fixconvs ------

def test_fixconvs_freezes_the_backbone():
    """One f32 train step of r3d_18 + mlp with fixconvs: no gradient
    reaches the backbone (its parameters bit-equal after the step), the
    head's gradients are the JAX package's (stop_gradient), and the BN
    running statistics still move."""
    model, params, state = jax_weights("r3d_18", seed=6, fixconvs=True)
    data, ce = batches(1)
    x, z, labels, weight = data[0]

    def loss(p):
        emb, new_state = model.apply(p, state, x, train=True,
                                     compute_dtype=jnp.float32)
        return jnp.mean(jnp.square(emb - z)), new_state

    (want_loss, want_state), want_g = jax.jit(jax.value_and_grad(
        loss, has_aux=True))(params)
    assert all(float(jnp.abs(g).max()) == 0.0
               for g in jax.tree.leaves(want_g["backbone"]))
    m = port_model(params, state, "r3d_18", fixconvs=True).train()
    before = {k: v.clone() for k, v in m.state_dict().items()}
    emb = m(torch.from_numpy(x))
    got_loss = torch.mean(torch.square(emb - torch.from_numpy(z)))
    got_loss.backward()
    np.testing.assert_allclose(got_loss.item(), float(want_loss), rtol=1e-5)
    for k, p in m.named_parameters():
        assert (p.grad is None) == k.startswith("model."), k
    got_g = bridge.flatten(bridge.to_jax(
        {k: p.grad for k, p in m.named_parameters() if p.grad is not None}
    )[0])
    for k, g in bridge.flatten(jax.tree.map(np.asarray,
                                            want_g["head"]), "head").items():
        assert np.abs(g).max() > 0, k
        np.testing.assert_allclose(got_g[k], g, atol=1e-5, rtol=1e-4,
                                   err_msg=k)
    assert_trees_close(bridge.to_jax(m.state_dict())[1],
                       jax.tree.map(np.asarray, want_state), atol=1e-5)
    opt = make_optimizer(m.parameters(), 1e-3)
    step = make_train_step(m, opt, compute_dtype=torch.float32)
    step(*as_torch(x, z, labels, weight, ce))
    after = m.state_dict()
    for k, v in before.items():
        moved = not torch.equal(after[k], v)
        if "running" in k or "tracked" in k:
            assert moved, k
        else:
            assert moved != k.startswith("model."), k


# ------------------------------------------------------------ remat ---------

class _CountConvs(TorchDispatchMode):
    """Counts the convolutions that run (a saved output is not run)."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += func is torch.ops.aten.convolution.default
        return func(*args, **(kwargs or {}))


def _loss_and_grads(m, x, z):
    m.train()
    loss = torch.mean(torch.square(m(torch.from_numpy(x))
                                   - torch.from_numpy(z)))
    count = _CountConvs()
    with count:
        loss.backward()
    grads = bridge.flatten(bridge.to_jax(
        {k: p.grad for k, p in m.named_parameters()})[0])
    return float(loss), grads, count.n


@pytest.mark.parametrize("remat", ["full", "convs"])
def test_remat_matches_the_plain_step_and_jax(remat):
    """r3d_18 + mlp in train mode, as JAX test_models.py:
    test_remat_grads_match: the loss within 1e-6 and every gradient within
    atol 1e-5 / rtol 1e-4 of the plain step's and of the JAX package's
    under the same remat; the BN running statistics after the step equal
    the plain step's (they move once, not again in the recomputation);
    'full' runs the 19 block convs again in the backward (the stem is not
    rematerialised), 'convs' none."""
    model, params, state = jax_weights("r3d_18", seed=8)
    x = _x((2, 1, 4, 32, 32, 3), 9)
    z = np.random.default_rng(10).normal(size=(2, 300)).astype(np.float32)
    jm = jax_network(Config(network="r3d_18", remat=remat))

    def loss(p):
        emb, _ = jm.apply(p, state, x, train=True, compute_dtype=jnp.float32)
        return jnp.mean(jnp.square(emb - z))

    want_loss, want_g = jax.jit(jax.value_and_grad(loss))(params)
    want_g = bridge.flatten(jax.tree.map(np.asarray, want_g))
    plain = port_model(params, state, "r3d_18")
    m = port_model(params, state, "r3d_18", remat=remat)
    assert m.backbone.remat == remat and plain.backbone.remat is False
    loss0, g0, recomputed0 = _loss_and_grads(plain, x, z)
    loss1, g1, recomputed1 = _loss_and_grads(m, x, z)
    assert (recomputed0, recomputed1) == (0, 19 if remat == "full" else 0)
    assert abs(loss1 - loss0) < 1e-6 and abs(loss1 - float(want_loss)) < 1e-6
    assert g1.keys() == g0.keys() == want_g.keys()
    for k in g0:
        np.testing.assert_allclose(g1[k], g0[k], atol=1e-5, rtol=1e-4,
                                   err_msg=k)
        np.testing.assert_allclose(g1[k], want_g[k], atol=1e-5, rtol=1e-4,
                                   err_msg=k)
    sd0, sd1 = plain.state_dict(), m.state_dict()
    for k, v in sd0.items():
        if "running" in k or "tracked" in k:
            assert torch.equal(sd1[k], v), k
    assert int(sd1["model.layer1.0.conv1.1.num_batches_tracked"]) == 1


# ------------------------------------------- train steps, linear head -------

def test_linear_head_train_steps_match_jax():
    """3 f32 steps of r3d_18 + the linear head (resnet18's model), dropout
    at rate 0 on both sides, from the same seeded non-zero Adam state: loss
    rtol 1e-4, parameters atol 2e-5 (as test_torch_train.
    test_train_steps_match_jax)."""
    model, params, state = jax_weights("r3d_18", seed=2, head="linear",
                                       warm_shape=(4, 1, 8, 32, 32, 3))
    model = dataclasses.replace(model, dropout_rate=0.0)
    data, ce = batches(3, b=4)
    moments = seeded_moments(params, 5)
    ts, want = jax_steps(model, params, state, data, ce, 1e-3, moments, 1000)
    m = port_model(params, state, "resnet18")
    assert (m.head, m.dropout_rate) == ("linear", 0.05)
    m.dropout_rate = 0.0
    opt = make_optimizer(m.parameters(), 1e-3)
    bridge.adam_from_jax(m, opt, *moments, 1000)
    step = make_train_step(m, opt, compute_dtype=torch.float32)
    got = [float(step(*as_torch(*d, ce))["loss"]) for d in data]
    np.testing.assert_allclose(got, [w[0] for w in want], rtol=1e-4)
    got_p, got_s = bridge.to_jax(m.state_dict())
    assert_trees_close(got_p, jax.tree.map(np.asarray, ts.params), atol=2e-5)
    assert_trees_close(got_s, jax.tree.map(np.asarray, ts.model_state),
                       atol=1e-3)


def test_linear_head_bridge_round_trip_through_porting():
    """JAX init -> bridge.from_jax -> port state_dict ->
    porting._port_reference_sd (the reference's layout: backbone under
    `model.`, `regressor.*` at the top level) gives back the trees."""
    model = jax_network(Config(network="resnet18"))
    params, state = jax.tree.map(np.array, jax.jit(model.init)(
        jax.random.PRNGKey(4)))
    m = get_network(PortConfig(network="resnet18"))
    m.load_state_dict(bridge.from_jax(params, state), strict=True)
    sd = {k: v.numpy() for k, v in m.state_dict().items()}
    assert "regressor.weight" in sd and "model.stem.0.weight" in sd
    p2, s2 = _port_reference_sd(sd, "r3d_18", "linear")
    assert jax.tree.structure(p2) == jax.tree.structure(params)
    assert jax.tree.all(jax.tree.map(np.array_equal, p2, params))
    assert jax.tree.all(jax.tree.map(np.array_equal, s2, state))


# ------------------------------------------------------------ the trainer ---

def test_cli_main_trains_resnet18_with_remat_and_embedding_pool(tmp_path,
                                                                capsys):
    """An epoch through the trainer with the linear head's dropout drawing
    from the per-epoch generator, remat 'convs' and per-clip pooling, then
    the zero-shot evaluation."""
    out = port_main.main([
        "--dataset", "synthetic", "--class_total", "8", "--train_samples",
        "8", "--n_epochs", "1", "--bs", "4", "--size", "32", "--clip_len",
        "8", "--device", "cpu", "--compute_dtype", "float32", "--save_path",
        str(tmp_path), "--no-progressbar", "--nopretrained", "--network",
        "resnet18", "--remat", "convs", "--clip_pool", "embedding"])
    text = capsys.readouterr().out
    assert "RESNET18 SYNTHETIC LR 0.001 BS 4 CLIP_LEN 8" in text
    assert np.isfinite(out["loss"]) and out["loss"] > 0
    assert 0 <= out["synthetic_test_accuracy"] <= 100
