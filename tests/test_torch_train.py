"""The port's training slice against the JAX package's, on the CPU at small
sizes: K2 as an autograd Function (forward and all six gradients) against
the Pallas op in interpret mode, train-mode BatchNorm statistics, the
train-mode forward of the full network, the loss / accuracy / schedule
functions, a sequence of train steps on the same batches, the non-finite
skip, bf16 compute with float32 masters, and the training CLI. Inputs come
from numpy seeds and weights cross through models/bridge."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zeroshotvideoclassification_tpu.config import Config
from zeroshotvideoclassification_tpu.models import get_network as jax_network
from zeroshotvideoclassification_tpu.models import layers as JL
from zeroshotvideoclassification_tpu.ops import bn_pallas
from zeroshotvideoclassification_tpu.ops.cdist import (
    nearest_class as jax_nearest_class,
)
from zeroshotvideoclassification_tpu.train import (
    TrainState as JaxTrainState,
    make_optimizer as jax_make_optimizer,
    make_train_step as jax_make_train_step,
    multistep_lr as jax_multistep_lr,
)
from zeroshotvideoclassification_tpu.train.step import (
    masked_mse as jax_masked_mse,
)
from zeroshotvideoclassification_tpu_torch.cli import main as port_main
from zeroshotvideoclassification_tpu_torch.models import bridge, get_network
from zeroshotvideoclassification_tpu_torch.models import layers as PL
from zeroshotvideoclassification_tpu_torch.ops.bn_cuda import bn_apply_relu
from zeroshotvideoclassification_tpu_torch.ops.cdist import nearest_class
from zeroshotvideoclassification_tpu_torch.train import (
    GuardedAdam,
    load_checkpoint,
    make_optimizer,
    make_train_step,
    masked_mse,
    multistep_lr,
)

from torch_helpers import randomize_bn

ARCH = "r2plus1d_18"


@pytest.fixture(autouse=True)
def grad_enabled():
    """Another test module switches autograd off for its whole process when
    it is imported; the tests here differentiate."""
    with torch.enable_grad():
        yield


@pytest.fixture
def interpret_pallas(monkeypatch):
    """Run the JAX package's Pallas BN kernels in interpret mode on the CPU,
    as tests/test_bn_pallas.py does, and open the model's gate to them."""
    from jax.experimental import pallas as pl

    orig = pl.pallas_call

    def wrapped(*a, **kw):
        kw["interpret"] = True
        return orig(*a, **kw)

    monkeypatch.setattr(bn_pallas.pl, "pallas_call", wrapped)
    monkeypatch.setenv("ZSVC_PALLAS_BN", "1")
    # the gate also asks for one device; the tests run on a virtual mesh of 8
    monkeypatch.setattr(JL, "_use_pallas_bn", bn_pallas.eligible)


def port_model(params, state, arch=ARCH, **cfg):
    m = get_network(Config(network=arch, **{"head": "mlp", **cfg}))
    m.load_state_dict(bridge.from_jax(params, state), strict=True)
    return m.to(memory_format=torch.channels_last_3d)


def jax_weights(arch=ARCH, seed=0, warm_shape=(2, 1, 8, 32, 32, 3), **cfg):
    """(JAX model, params, model_state) as writable numpy trees: the JAX
    init, random BN scale and bias, and running statistics warmed up on a
    seeded batch of `warm_shape` (one train-mode forward with momentum 1).
    `cfg` (head, clip_pool, ...) goes to both packages' get_network.
    bn_statistics shifts by the running mean; with running means far from
    the batch means its E[s^2] - E[s]^2 cancels on both sides, each in its
    own summation order, and the difference grows through the 37 layers."""
    model = jax_network(Config(network=arch, **{"head": "mlp", **cfg}))
    params, state = jax.jit(model.init)(jax.random.PRNGKey(seed))
    params = jax.tree.map(np.array, params)
    state = jax.tree.map(np.array, state)
    rng = np.random.default_rng(seed)
    randomize_bn(params, state, rng)
    m = port_model(params, state, arch, **cfg).train()
    for bn in m.modules():
        if isinstance(bn, PL.BatchNorm3d):
            bn.momentum = 1.0
    with torch.no_grad():
        m(torch.from_numpy(rng.uniform(-0.5, 0, warm_shape).astype(
            np.float32)))
    warmed = bridge.flatten(bridge.to_jax(m.state_dict())[1])

    def fill(tree, prefix):  # keep the JAX tree's shape (its empty dicts)
        for k, v in tree.items():
            if isinstance(v, dict):
                fill(v, f"{prefix}{k}/")
            else:
                tree[k] = warmed[prefix + k]

    fill(state, "")
    return model, params, state


def jax_leaf_shapes(model):
    """{port state_dict key: shape} of a JAX ZeroShotModel's params and
    model_state, through the bridge's names and layouts (nothing
    allocated)."""
    params, state = jax.eval_shape(model.init, jax.random.PRNGKey(0))
    out = {}
    for tree in (params, state):
        for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
            jpath = "/".join(p.key for p in path)
            shape = leaf.shape
            if jpath.endswith("/w"):  # conv DHWIO -> OIDHW, linear [out, in]
                shape = [shape[i] for i in ((4, 3, 0, 1, 2) if len(shape) == 5
                                            else (1, 0))]
            out[bridge.torch_key(jpath)] = tuple(shape)
    return out


def batches(n, b=2, classes=5, seed=11):
    """n batches (x, z, labels, weight) of b clips of 8x32x32 and one set of
    unit class embeddings, numpy."""
    r = np.random.default_rng(seed)
    ce = r.normal(size=(classes, 300)).astype(np.float32)
    ce /= np.linalg.norm(ce, axis=1, keepdims=True)
    out = []
    for _ in range(n):
        labels = r.integers(0, classes, b).astype(np.int32)
        x = r.uniform(-0.5, 0, (b, 1, 8, 32, 32, 3)).astype(np.float32)
        out.append((x, ce[labels], labels, np.ones(b, np.float32)))
    return out, ce


def as_torch(*arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


def assert_trees_close(got, want, atol, rtol=0.0):
    got, want = bridge.flatten(got), bridge.flatten(want)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], np.asarray(want[k]), atol=atol,
                                   rtol=rtol, err_msg=k)


# ------------------------------------------------------------ (a) K2 op -----

@pytest.mark.parametrize("with_res", [False, True])
@pytest.mark.parametrize("relu", [True, False])
def test_k2_function_matches_pallas_fwd_and_grads(interpret_pallas, with_res,
                                                  relu):
    """Forward within 2e-6 and every gradient within atol 5e-4 / rtol 1e-4
    (the bars of tests/test_bn_pallas.py) of the Pallas op's custom VJP."""
    rng = np.random.default_rng(0)
    shape = (2, 3, 4, 8, 6)  # [N, T, H, W, C]
    c = shape[-1]
    x = rng.normal(size=shape).astype(np.float32)
    res = rng.normal(size=shape).astype(np.float32) if with_res else None
    stats = [rng.uniform(0.5, 2.0, c).astype(np.float32),
             rng.normal(size=c).astype(np.float32),
             rng.normal(size=c).astype(np.float32),
             rng.uniform(0.3, 3.0, c).astype(np.float32)]
    w = rng.normal(size=shape).astype(np.float32)  # cotangent

    def loss(x, scale, bias, mean, var, res):
        y = bn_pallas.bn_apply_relu_pallas(x, scale, bias, mean, var, res,
                                           relu, 1e-5)
        return jnp.sum(y * w), y

    argnums = tuple(range(6 if with_res else 5))
    (_, want_y), want = jax.value_and_grad(loss, argnums, has_aux=True)(
        jnp.asarray(x), *map(jnp.asarray, stats),
        None if res is None else jnp.asarray(res))

    args = [t.requires_grad_() for t in as_torch(x, *stats)]
    rt = None if res is None else torch.from_numpy(res).requires_grad_()
    y = bn_apply_relu(*args, rt, relu, 1e-5)
    got = torch.autograd.grad((y * torch.from_numpy(w)).sum(),
                              args + ([rt] if with_res else []))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(want_y),
                               atol=2e-6)
    names = ["dx", "d_scale", "d_bias", "d_mean", "d_var", "d_res"]
    for n, a, b in zip(names, got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=5e-4,
                                   rtol=1e-4, err_msg=n)


def test_k2_relu_mask_reads_the_stored_bf16_output():
    """A pre-activation that is positive in float32 but rounds to 0 in bf16
    must block the gradient, as bn_pallas.py:95-97 reads the mask from y."""
    c = 4
    x = torch.full((1, 2, c), 2.0 ** -133).to(torch.bfloat16)  # least bf16
    assert float(x.float().min()) == 2.0 ** -133
    x[0, 1] = 1.0
    x.requires_grad_()
    one, zero = torch.ones(c), torch.zeros(c)
    # a = 0.25: x * a = 2^-135 > 0 in float32, 0 once rounded to bf16
    y = bn_apply_relu(x, 0.25 * one, zero, zero, one - 1e-5, None, True, 1e-5)
    (dx,) = torch.autograd.grad(y.float().sum(), x)
    assert float(y.detach()[0, 0].abs().max()) == 0.0
    assert float(dx[0, 0].abs().max()) == 0.0 and float(dx[0, 1].min()) > 0


# --------------------------------------------------- (b) BN statistics ------

@pytest.mark.parametrize("offset", [0.0, 300.0])
def test_bn_statistics_match_jax(offset):
    """mean / var and the new running statistics within 1e-6 (relative to
    the statistics' size where the input has a large DC offset)."""
    rng = np.random.default_rng(3)
    shape = (2, 4, 6, 6, 5)
    x = (rng.normal(size=shape) * rng.uniform(0.3, 1, 5) + offset
         + rng.normal(size=5)).astype(np.float32)
    m0 = (offset + rng.normal(size=5)).astype(np.float32)
    v0 = rng.uniform(0.5, 2, 5).astype(np.float32)
    want = JL.bn_statistics({"mean": jnp.asarray(m0), "var": jnp.asarray(v0)},
                            jnp.asarray(x), True, 0.1)
    xt = torch.from_numpy(x).requires_grad_()
    mean, var, new_mean, new_var = PL.bn_statistics(
        xt, torch.from_numpy(m0), torch.from_numpy(v0), 0.1)
    tol = 1e-6 * max(1.0, abs(offset))
    np.testing.assert_allclose(mean.detach().numpy(), np.asarray(want[0]),
                               atol=tol)
    np.testing.assert_allclose(var.detach().numpy(), np.asarray(want[1]),
                               atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(new_mean.numpy(),
                               np.asarray(want[2]["mean"]), atol=tol)
    np.testing.assert_allclose(new_var.numpy(), np.asarray(want[2]["var"]),
                               atol=1e-6, rtol=1e-6)
    assert mean.requires_grad and var.requires_grad
    assert not new_mean.requires_grad and not new_var.requires_grad
    # against the two-pass float64 statistics: the shift keeps the variance
    x64 = x.astype(np.float64).reshape(-1, 5)
    np.testing.assert_allclose(var.detach().numpy(), x64.var(0), rtol=1e-4)


def test_train_mode_bn_updates_running_stats_in_place():
    bn = PL.BatchNorm3d(5)
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.normal(2.0, 3.0, (2, 5, 3, 4, 4)).astype(
        np.float32))
    bn.train()
    y = bn(x, relu=False)
    a = x.permute(0, 2, 3, 4, 1).reshape(-1, 5).double()
    np.testing.assert_allclose(bn.running_mean.numpy(),
                               0.1 * a.mean(0).numpy(), atol=1e-6)
    np.testing.assert_allclose(
        bn.running_var.numpy(),
        0.9 + 0.1 * a.var(0, unbiased=True).numpy(), atol=1e-5)
    assert int(bn.num_batches_tracked) == 1
    yl = y.permute(0, 2, 3, 4, 1).reshape(-1, 5)
    np.testing.assert_allclose(yl.mean(0).detach().numpy(), 0, atol=1e-5)
    np.testing.assert_allclose(yl.var(0, unbiased=False).detach().numpy(),
                               1, atol=1e-3)


# ------------------------------------------- (c) train-mode forward ---------

@pytest.mark.parametrize("arch", ["r2plus1d_18", "r3d_18", "mc3_18"])
def test_train_mode_forward_matches_jax(interpret_pallas, arch):
    """Embedding and every BN running statistic after one train-mode forward,
    atol/rtol 1e-4 (the bar of tests/test_full_network_parity.py). The JAX
    side runs its Pallas epilogue (x * a + b, the form K2 computes) where
    the shape is eligible for it."""
    shape = (2, 2, 8, 32, 32, 3)
    model, params, state = jax_weights(arch, seed=1, warm_shape=shape)
    x = np.random.default_rng(7).uniform(-0.5, 0, shape).astype(np.float32)
    want, new_state = jax.jit(lambda p, s, xx: model.apply(
        p, s, xx, train=True, rng=None, compute_dtype=jnp.float32))(
            params, state, x)
    m = port_model(params, state, arch).train()
    got = m(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=1e-4, rtol=1e-4)
    _, got_state = bridge.to_jax(m.state_dict())
    assert_trees_close(got_state, jax.tree.map(np.asarray, new_state),
                       atol=1e-4, rtol=1e-4)
    assert all(int(b.num_batches_tracked) == 1 for b in m.modules()
               if isinstance(b, PL.BatchNorm3d))


# ----------------------------------- (d) loss, accuracy, schedule -----------

@pytest.mark.parametrize("weights", [[1, 1, 0, 1], [0, 0, 0, 0]])
def test_masked_mse_matches_jax(weights):
    rng = np.random.default_rng(5)
    emb = rng.normal(size=(4, 300)).astype(np.float32)
    z = rng.normal(size=(4, 300)).astype(np.float32)
    w = np.asarray(weights, np.float32)
    want = float(jax_masked_mse(jnp.asarray(emb), jnp.asarray(z),
                                jnp.asarray(w)))
    et = torch.from_numpy(emb).requires_grad_()
    got = masked_mse(et, torch.from_numpy(z), torch.from_numpy(w))
    np.testing.assert_allclose(float(got), want, rtol=1e-6, atol=1e-12)
    (g,) = torch.autograd.grad(got, et)
    assert bool(torch.isfinite(g).all())
    if not w.any():  # a finite step with zero gradients, not a skip
        assert float(got) == 0.0 and float(g.abs().max()) == 0.0


def test_nearest_class_matches_jax():
    rng = np.random.default_rng(6)
    pred = rng.normal(size=(17, 300)).astype(np.float32)
    ce = rng.normal(size=(9, 300)).astype(np.float32)
    want = np.asarray(jax_nearest_class(jnp.asarray(pred), jnp.asarray(ce)))
    got = nearest_class(*as_torch(pred, ce))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("lr,n_epochs", [(1e-3, 150), (1e-4, 20), (1e-2, 7)])
def test_multistep_lr_matches_jax(lr, n_epochs):
    a, b = multistep_lr(lr, n_epochs), jax_multistep_lr(lr, n_epochs)
    assert [a(e) for e in range(n_epochs + 130)] == [
        b(e) for e in range(n_epochs + 130)]


# ------------------------------------------------ (e) train steps -----------

def seeded_moments(params, seed):
    """Adam moments as after many steps: mu ~ 3e-3 N(0, 1), sqrt(nu) ~ 3e-2,
    shaped like `params` (numpy)."""
    rng = np.random.default_rng(seed)
    mu = jax.tree.map(lambda a: (3e-3 * rng.normal(size=a.shape)).astype(
        np.float32), params)
    nu = jax.tree.map(lambda a: (1e-3 * rng.uniform(0.5, 2, a.shape)).astype(
        np.float32), params)
    return mu, nu


def jax_steps(model, params, state, data, ce, lr, moments=None, count=0):
    opt = jax_make_optimizer(lr)
    opt_state = opt.init(params)
    if moments is not None:
        guard = opt_state.inner_state
        adam = guard.inner_state[0]._replace(
            count=jnp.asarray(count, jnp.int32),
            mu=jax.tree.map(jnp.asarray, moments[0]),
            nu=jax.tree.map(jnp.asarray, moments[1]))
        opt_state = opt_state._replace(inner_state=guard._replace(
            inner_state=(adam,) + tuple(guard.inner_state[1:])))
    ts = JaxTrainState(params=jax.tree.map(jnp.asarray, params),
                       model_state=jax.tree.map(jnp.asarray, state),
                       opt_state=opt_state, step=jnp.zeros((), jnp.int32))
    step = jax_make_train_step(model, opt, compute_dtype=jnp.float32,
                               donate=False)
    out = []
    for x, z, labels, weight in data:
        ts, m = step(ts, x, z, labels, weight, ce, jax.random.PRNGKey(0))
        out.append((float(m["loss"]), float(m["train_accuracy"])))
    return ts, out


def port_steps(params, state, data, ce, lr, dtype=torch.float32,
               moments=None, count=0):
    m = port_model(params, state)
    opt = make_optimizer(m.parameters(), lr)
    if moments is not None:
        bridge.adam_from_jax(m, opt, *moments, count)
    step = make_train_step(m, opt, compute_dtype=dtype)
    out = []
    for x, z, labels, weight in data:
        r = step(*as_torch(x, z, labels, weight, ce))
        out.append((float(r["loss"]), float(r["train_accuracy"])))
    return m, opt, step, out


def test_train_steps_match_jax(interpret_pallas):
    """4 steps on the same batches of 4 clips, the JAX side through its
    Pallas BN epilogue in interpret mode. Reached / held:

      loss                 1.4e-5 / rtol 1e-4
      parameters           6.9e-6 / atol 2e-5  (the bar the JAX package holds
                           its own scan-fused steps to, test_train_eval.py)
      Adam second moment   1.7e-8 / atol 2e-5
      Adam first moment    1.3e-4 / atol 5e-4
      BN running stats     2.3e-4 / atol 1e-3

    The loss is not at that test's 1e-5 because there one XLA program is
    compared with itself, here XLA's float32 convolutions and reductions
    with PyTorch's. The first moment is 0.1 * gradient per step, and at 4
    clips of 8x32x32 the gradient itself is only that sharp: the late
    layers' batch statistics span 16 to 128 positions, and the JAX
    package's own two BN paths differ by 2e-2 of a leaf's largest gradient
    entry on such a batch. The running statistics of those layers inherit
    it. Gradients are held tightly where they are well conditioned, in
    test_block_gradients_match_jax.

    Both sides start from the same non-zero Adam state (count 1000,
    sqrt(nu) ~ 3e-2), under which that gradient noise moves a weight by
    < 1e-5 while the step itself moves it by > 1e-4. From zero moments
    Adam's first updates are lr * g / |g|: every weight moves by ~lr
    whatever its gradient's size, a gradient entry near zero changes sign
    with the float32 summation order, and the two parameter sets land 2e-3
    apart after one step (test_first_adam_step_matches_jax_from_zero_moments
    holds the entries that are clear of zero)."""
    model, params, state = jax_weights(seed=2, warm_shape=(4, 1, 8, 32, 32, 3))
    data, ce = batches(4, b=4)
    moments = seeded_moments(params, 5)
    ts, want = jax_steps(model, params, state, data, ce, 1e-3, moments, 1000)
    m, opt, step, got = port_steps(params, state, data, ce, 1e-3,
                                   moments=moments, count=1000)
    np.testing.assert_allclose([g[0] for g in got], [w[0] for w in want],
                               rtol=1e-4)
    np.testing.assert_allclose([g[1] for g in got], [w[1] for w in want])
    got_p, got_s = bridge.to_jax(m.state_dict())
    assert_trees_close(got_p, jax.tree.map(np.asarray, ts.params), atol=2e-5)
    assert_trees_close(got_s, jax.tree.map(np.asarray, ts.model_state),
                       atol=1e-3)
    adam = ts.opt_state.inner_state.inner_state[0]
    mu, nu, count = bridge.adam_to_jax(m, opt)
    assert_trees_close(mu, jax.tree.map(np.asarray, adam.mu), atol=5e-4)
    assert_trees_close(nu, jax.tree.map(np.asarray, adam.nu), atol=2e-5)
    assert step.state.step == int(ts.step) == 4
    assert count == int(adam.count) == 1004
    # the update moved the weights by far more than the bar
    moved = np.abs(bridge.flatten(got_p)["backbone/stem/conv1/w"]
                   - params["backbone"]["stem"]["conv1"]["w"]).max()
    assert moved > 1e-4


def test_first_adam_step_matches_jax_from_zero_moments(interpret_pallas):
    """One step from zero moments: the loss within rtol 2e-5, and the
    parameters within atol 2e-5 wherever the gradient is clear of zero (at
    least 1e-2 of its leaf's largest entry); Adam's first update is
    lr * sign(g), so an entry that is noise in float32 may land 2 * lr away
    (test_train_steps_match_jax)."""
    model, params, state = jax_weights(seed=2)
    data, ce = batches(1)
    ts, want = jax_steps(model, params, state, data, ce, 1e-3)
    m, opt, _, got = port_steps(params, state, data, ce, 1e-3)
    np.testing.assert_allclose(got[0][0], want[0][0], rtol=2e-5)
    got_p = bridge.flatten(bridge.to_jax(m.state_dict())[0])
    want_p = bridge.flatten(jax.tree.map(np.asarray, ts.params))
    mu = bridge.flatten(bridge.adam_to_jax(m, opt)[0])  # 0.1 * gradient
    checked = 0
    for k, w in want_p.items():
        clear = np.abs(mu[k]) >= 1e-2 * np.abs(mu[k]).max()
        checked += int(clear.sum())
        np.testing.assert_allclose(got_p[k][clear], w[clear], atol=2e-5,
                                   err_msg=k)
    assert checked > 0.5 * sum(w.size for w in want_p.values())
    assert int(opt.count) == 1 and opt.count.dtype == torch.int64


@pytest.mark.parametrize("stride", [1, 2])
def test_block_gradients_match_jax(interpret_pallas, stride):
    """One R(2+1)D BasicBlock in train mode, with batch statistics over
    >= 512 positions: output, input gradient and every parameter gradient
    against the JAX block (Pallas epilogues in interpret mode), each within
    1e-4 of its largest entry."""
    from zeroshotvideoclassification_tpu.models import resnet3d as JR
    from zeroshotvideoclassification_tpu_torch.models.resnet3d import (
        TWO_PLUS_ONE,
        BasicBlock,
    )

    cin, cout = (8, 8) if stride == 1 else (8, 16)
    rng = np.random.default_rng(stride)
    params, state = JR._block_init(jax.random.PRNGKey(0), "2plus1d", cin,
                                   cout, stride)
    params = jax.tree.map(np.array, params)
    state = jax.tree.map(np.array, state)
    randomize_bn(params, state, rng)
    x = rng.normal(size=(2, 8, 16, 16, cin)).astype(np.float32)
    w = rng.normal(size=(2, 8 // stride, 16 // stride, 16 // stride,
                         cout)).astype(np.float32)

    def loss(p, xx):
        y, _ = JR._block_apply("2plus1d", p, state, xx, stride, True,
                               jnp.float32)
        return jnp.sum(y * w), y

    (_, want_y), (want_gp, want_gx) = jax.jit(jax.value_and_grad(
        loss, (0, 1), has_aux=True))(params, x)

    block = BasicBlock(TWO_PLUS_ONE, cin, cout, stride)
    prefix = "model.layer1.0."
    sd = bridge.from_jax({"backbone": {"layer1_0": params}},
                         {"backbone": {"layer1_0": state}})
    block.load_state_dict({k[len(prefix):]: v for k, v in sd.items()})
    block = block.to(memory_format=torch.channels_last_3d).train()
    xt = torch.from_numpy(x).permute(0, 4, 1, 2, 3).requires_grad_()
    y = block(xt)
    (y.permute(0, 2, 3, 4, 1) * torch.from_numpy(w)).sum().backward()

    def close(got, want, what):
        want = np.asarray(want)
        np.testing.assert_allclose(got, want, atol=1e-4 * np.abs(want).max(),
                                   err_msg=what)

    close(y.detach().permute(0, 2, 3, 4, 1).numpy(), want_y, "y")
    close(xt.grad.permute(0, 2, 3, 4, 1).numpy(), want_gx, "dx")
    got_gp, _ = bridge.to_jax({prefix + k: p.grad
                               for k, p in block.named_parameters()})
    got_gp = bridge.flatten(got_gp["backbone"]["layer1_0"])
    want_gp = bridge.flatten(jax.tree.map(np.asarray, want_gp))
    assert got_gp.keys() == want_gp.keys()
    for k in want_gp:
        close(got_gp[k], want_gp[k], k)


# ------------------------------------------------ (f) non-finite skip -------

def test_nonfinite_grads_skip_update():
    """A NaN batch leaves params, both moments and the count untouched and
    counts the skip (tests/test_train_eval.py::
    test_nonfinite_grads_skip_update)."""
    _, params, state = jax_weights(seed=3)
    data, ce = batches(2)
    m = port_model(params, state)
    opt = make_optimizer(m.parameters(), 1e-2)
    assert isinstance(opt, GuardedAdam)
    step = make_train_step(m, opt, compute_dtype=torch.float32)
    step(*as_torch(*data[0], ce))  # non-zero Adam moments first
    before = {k: v.clone() for k, v in m.state_dict().items()
              if "running" not in k and "tracked" not in k}
    moments = [(opt.state[p]["exp_avg"].clone(),
                opt.state[p]["exp_avg_sq"].clone()) for p in m.parameters()]
    x, z, labels, weight = data[1]
    out = step(*as_torch(np.full_like(x, np.nan), z, labels, weight, ce))
    assert not np.isfinite(float(out["loss"]))
    for k, v in before.items():
        assert torch.equal(m.state_dict()[k], v), k
    for p, (a, b) in zip(m.parameters(), moments):
        assert torch.equal(opt.state[p]["exp_avg"], a)
        assert torch.equal(opt.state[p]["exp_avg_sq"], b)
        assert float(opt.state[p]["step"]) == 1
    assert int(opt.notfinite_count) == 1 and int(opt.total_notfinite) == 1
    assert not bool(opt.last_finite) and step.state.step == 2
    # the next finite step goes through and clears the consecutive count
    for bn in m.modules():  # the NaN batch poisoned the running statistics
        if isinstance(bn, PL.BatchNorm3d):
            bn.running_mean.zero_()
            bn.running_var.fill_(1.0)
    step(*as_torch(*data[1], ce))
    assert int(opt.count) == 2 and int(opt.notfinite_count) == 0
    assert int(opt.total_notfinite) == 1 and bool(opt.last_finite)
    assert not torch.equal(m.state_dict()["model.stem.0.weight"],
                           before["model.stem.0.weight"])


# ------------------------------------------------ (g) bf16 compute ----------

def test_bf16_steps_keep_float32_masters():
    """2 steps with bf16 convs: every loss within 2e-2 relative of the
    float32 run (bf16 keeps 8 bits; the loss is a mean over 600 squared
    differences of unit vectors), parameters, gradients and moments
    float32."""
    _, params, state = jax_weights(seed=4)
    data, ce = batches(2)
    _, _, _, want = port_steps(params, state, data, ce, 1e-3)
    m, opt, _, got = port_steps(params, state, data, ce, 1e-3,
                                torch.bfloat16)
    np.testing.assert_allclose([g[0] for g in got], [w[0] for w in want],
                               rtol=2e-2)
    for p in m.parameters():
        assert p.dtype == torch.float32 and p.grad.dtype == torch.float32
        assert opt.state[p]["exp_avg"].dtype == torch.float32
        assert opt.state[p]["exp_avg_sq"].dtype == torch.float32
    assert m.compute_dtype == torch.bfloat16
    conv = m.model.stem[0]
    assert conv(torch.zeros(1, 3, 2, 8, 8)).dtype == torch.bfloat16


# ------------------------------------------------ (h) the training CLI ------

def test_cli_main_trains_one_epoch_on_cpu(tmp_path, capsys):
    out = port_main.main([
        "--dataset", "synthetic", "--class_total", "8", "--train_samples",
        "8", "--n_epochs", "1", "--bs", "4", "--size", "32", "--clip_len",
        "8", "--device", "cpu", "--compute_dtype", "float32", "--save_path",
        str(tmp_path), "--no-progressbar", "--nopretrained"])
    text = capsys.readouterr()
    assert "R2PLUS1D_18 SYNTHETIC LR 0.001 BS 4 CLIP_LEN 8" in text.out
    assert "Train Accuracy: regressor" in text.out
    assert "clips/sec" in text.out and "----- Epoch 0 done" in text.out
    # the epoch ends with the zero-shot evaluation of the test table; an
    # epoch that improves the best accuracy writes the best checkpoint
    assert "SYNTHETIC_TEST Epoch 0: Test accuracy:" in text.out
    assert "NOT EVALUATED" not in text.err
    assert 0 <= out["synthetic_test_accuracy"] <= 100
    assert out["best_accuracy"] == out["synthetic_test_accuracy"]
    assert "Best accuracy %.1f" % out["best_accuracy"] in text.out
    assert np.isfinite(out["loss"]) and out["loss"] > 0
    assert 0 <= out["train_accuracy"] <= 100 and out["clips_per_sec"] > 0
    runs = [d for d, _, files in os.walk(tmp_path) if "metrics.jsonl" in files]
    assert len(runs) == 1
    assert any(f.startswith("train_samples_") for f in os.listdir(runs[0]))
    ckpt = os.path.join(runs[0], "checkpoint.npz")
    assert os.path.exists(ckpt) == (out["best_accuracy"] > 0)
    if os.path.exists(ckpt):  # it loads strictly, optimizer state and all
        m = get_network(Config(network=ARCH, head="mlp"))
        meta = load_checkpoint(ckpt, m, make_optimizer(m.parameters()))
        assert meta["epoch"] == 0 and meta["step"] == 2
        assert meta["accuracy"] == out["best_accuracy"]


class _Built(Exception):
    """Raised in place of building the datasets: the flags got through."""


@pytest.mark.parametrize("flags", [
    ["--network", "resnet18"], ["--clip_pool", "embedding"], ["--fixconvs"],
    ["--head", "linear"], ["--network", "c3d"], ["--remat"],
    ["--remat", "convs"], ["--debug_nans"], ["--steps_per_call", "4"],
    ["--save_samples"]])
def test_cli_main_accepts_the_p8_flags(flags, tmp_path, monkeypatch):
    """Each flag of P8 (the models and options), of P11a
    (--steps_per_call, --debug_nans) and of P11b (--save_samples) gets
    through the trainer's checks,
    and the model it asks for is the JAX package's for the same flags: the
    same backbone, head, dropout, clip pooling, frozen convs and remat, and
    the same tensors under the bridge's names. Checked where the datasets
    would be built, before any is."""
    from zeroshotvideoclassification_tpu_torch.config import (
        config_from_namespace,
    )

    def stop(config, wv_model):
        raise _Built(config)

    monkeypatch.setattr(port_main, "build_datasets", stop)
    base = ["--dataset", "synthetic", "--device", "cpu", "--save_path",
            str(tmp_path)]
    with pytest.raises(_Built) as built:
        port_main.main(base + flags)
    config = built.value.args[0]
    assert config == config_from_namespace(
        port_main.build_arg_parser().parse_args(base + flags))
    jm = jax_network(Config(**dataclasses.asdict(config)))
    with torch.device("meta"):
        pm = get_network(config)
    assert pm.head == jm.head and pm.fixconvs == jm.fixconvs
    assert pm.dropout_rate == pytest.approx(jm.dropout_rate)
    assert pm.clip_pool == jm.clip_pool
    assert getattr(pm.backbone, "remat", False) == getattr(jm.backbone,
                                                           "remat", False)
    got = {k: tuple(v.shape) for k, v in pm.state_dict().items()
           if not k.endswith("num_batches_tracked")}
    assert got == jax_leaf_shapes(jm)


def test_cli_main_refuses_graphs_on_cuda_under_gloo(tmp_path, monkeypatch):
    """--steps_per_call 2 on CUDA captures the collectives into CUDA graphs,
    which gloo cannot give: under a gloo group it raises ValueError naming
    NCCL, before any dataset is built (and before looking for a GPU); the
    CPU under the same group is accepted."""
    import torch.distributed as dist

    def stop(config, wv_model):
        raise _Built(config)

    monkeypatch.setattr(port_main, "build_datasets", stop)
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        base = ["--dataset", "synthetic", "--save_path", str(tmp_path),
                "--steps_per_call", "2"]
        with pytest.raises(ValueError, match="NCCL"):
            port_main.main(base + ["--device", "cuda"])
        with pytest.raises(_Built):
            port_main.main(base + ["--device", "cpu"])
    finally:
        dist.destroy_process_group()


def test_cli_main_needs_a_gpu_unless_told_otherwise(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_main.main(["--dataset", "synthetic", "--save_path",
                        str(tmp_path), "--nopretrained"])
