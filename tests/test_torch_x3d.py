"""X3D-M in the port (models/x3d.py, ops/se_swish.py) against the plain
float32 reference tests/x3d_reference.py, on the CPU at 2 clips of 4 x 32
x 32 with seeded random weights and BN statistics: a train step through
make_train_step (loss, every parameter's gradient, the running
statistics), the train- and eval-mode embeddings, the blocks
rematerialised, se_swish's gradient in float64, the channel-wise conv,
the spans a forward opens, the parameter count, routing and the
trainer's CLI with a checkpoint."""

import math

import pytest
import torch
import torch.nn.functional as F

import x3d_reference as ref
from torch_helpers import calibrate_bn
from zeroshotvideoclassification_tpu_torch.config import Config
from zeroshotvideoclassification_tpu_torch.models import get_network
from zeroshotvideoclassification_tpu_torch.models import layers as L
from zeroshotvideoclassification_tpu_torch.models.heads import (
    check_tensor_parallel,
)
from zeroshotvideoclassification_tpu_torch.models.x3d import (
    X3D,
    channelwise,
    round_width,
)
from zeroshotvideoclassification_tpu_torch.ops.se_swish import se_swish
from zeroshotvideoclassification_tpu_torch.train import (
    make_optimizer,
    make_train_step,
)
from zeroshotvideoclassification_tpu_torch.utils import profiler

CLIP, SIZE, B = 4, 32, 2
# float32 through 26 blocks and 84 batch norms, summed in other orders by
# the port (one-pass statistics shifted by the running mean, K2's folded
# affine, channels-last convs) and the reference (two passes). Embeddings,
# loss and running statistics: the port reads up to 7e-7 from the
# reference, the reference 5e-7 from itself in float64
ATOL, RTOL = 5e-6, 5e-5
# each parameter's gradient, as a share of its largest entry: the port
# reads up to 7.2e-4 (the stem's and the first block's, whose gradients
# pass back through every block), the float32 reference 4e-5 from float64
GRAD_SHARE = 2e-3


def _model(remat=False):
    return get_network(Config(network="x3d_m", clip_len=CLIP, size=SIZE,
                              remat=remat))


def _params(seed=0, calibration=1):
    """The port's state_dict, seeded: He-normal convs, uniform biases and
    linears, and BN statistics like a trained network's
    (torch_helpers.calibrate_bn over the batch `_batch(calibration)`:
    running statistics of that batch, so the port's one-pass statistics,
    shifted by the running mean, do not cancel; small random scales)."""
    model = _model()
    L.init_weights(model, torch.Generator().manual_seed(seed))
    calibrate_bn(model.eval(), _batch(calibration)[0], seed)
    return {k: v.clone() for k, v in model.state_dict().items()}


def _loaded(P, remat=False):
    model = _model(remat)
    model.load_state_dict(P)
    return model.to(memory_format=torch.channels_last_3d)


def _batch(seed=1):
    g = torch.Generator().manual_seed(seed)
    x = torch.rand(B, 1, CLIP, SIZE, SIZE, 3, generator=g) - 0.5
    z = F.normalize(torch.randn(B, 300, generator=g), dim=-1)
    return (x, z, torch.zeros(B, dtype=torch.int32), torch.ones(B),
            F.normalize(torch.randn(5, 300, generator=g), dim=-1))


def _reference_step(P, x, z, weight):
    names = [k for k in P if not k.endswith(("running_mean", "running_var",
                                             "num_batches_tracked"))]
    Q = {k: (v.clone().requires_grad_(True) if k in names else v)
         for k, v in P.items()}
    stats = {}
    with torch.enable_grad():
        emb = ref.forward(Q, x, train=True, stats=stats)
        loss = ref.loss(emb, z, weight)
        grads = torch.autograd.grad(loss, [Q[k] for k in names])
    return emb.detach(), loss.detach(), dict(zip(names, grads)), stats


def _close(got, want, what):
    torch.testing.assert_close(got, want, atol=ATOL, rtol=RTOL, msg=what)


@pytest.mark.parametrize("remat", [False, "full", "convs"])
def test_train_step_matches_the_reference(remat):
    P = _params()
    x, z, labels, weight, classes = _batch()
    emb_ref, loss_ref, grads_ref, stats_ref = _reference_step(P, x, z,
                                                              weight)
    model = _loaded(P, remat)
    step = make_train_step(model, make_optimizer(model.parameters(), 1e-3),
                           compute_dtype=torch.float32)
    with torch.enable_grad():
        metrics = step(x, z, labels, weight, classes)
    _close(metrics["loss"], loss_ref, "loss")
    named = dict(model.named_parameters())
    assert set(named) == set(grads_ref)
    for k, g in grads_ref.items():
        torch.testing.assert_close(named[k].grad, g, rtol=0,
                                   atol=GRAD_SHARE * float(g.abs().max()),
                                   msg=k)
    buffers = dict(model.named_buffers())
    assert len(stats_ref) == 84
    for name, (mean, var) in stats_ref.items():
        _close(buffers[name + ".running_mean"], mean, name)
        _close(buffers[name + ".running_var"], var, name)
        # one move a step, recomputation or not
        assert int(buffers[name + ".num_batches_tracked"]) == 1
    # the train-mode embeddings of the same weights and batch
    with torch.no_grad():
        _close(_loaded(P).train()(x), emb_ref, "embeddings")


def test_eval_forward_matches_the_reference():
    P = _params(2, calibration=3)
    x = _batch(4)[0]
    with torch.no_grad():
        got = _loaded(P).eval()(x)
        want = ref.forward(P, x, train=False)
    _close(got, want, "eval embeddings")


@pytest.mark.parametrize("with_se", [True, False])
def test_se_swish_gradient_matches_the_plain_formula(with_se):
    g = torch.Generator().manual_seed(4)
    y = torch.randn(3, 16, 2, 3, 5, generator=g, dtype=torch.float64)
    y = y.to(memory_format=torch.channels_last_3d).requires_grad_(True)
    fc1 = torch.nn.Conv3d(16, 8, 1, bias=True).double()
    fc2 = torch.nn.Conv3d(8, 16, 1, bias=True).double()
    fcs = (fc1, fc2) if with_se else ()
    params = [y] + [p for fc in fcs for p in fc.parameters()]
    with torch.enable_grad():
        out = se_swish(y, *fcs)
        s = y
        if with_se:
            gate = torch.sigmoid(fc2(torch.relu(fc1(
                y.mean(dim=(2, 3, 4), keepdim=True)))))
            s = y * gate
        want = s * torch.sigmoid(s)
        dout = torch.randn(out.shape, generator=g, dtype=torch.float64)
        got_g = torch.autograd.grad(out, params, dout)
        want_g = torch.autograd.grad(want, params, dout)
        # float64 on both sides: only the order of the sums differs
        torch.testing.assert_close(out, want, rtol=1e-12, atol=1e-12)
        for a, b in zip(got_g, want_g):
            torch.testing.assert_close(a, b, rtol=1e-10, atol=1e-12)
        assert torch.autograd.gradcheck(lambda t: se_swish(t, *fcs), (y,))
    assert out.is_contiguous(memory_format=torch.channels_last_3d)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kernel,stride,padding", [
    (3, (1, 2, 2), 1), ((5, 1, 1), 1, (2, 0, 0))])
def test_channelwise_conv3d_is_f_conv3d(kernel, stride, padding, dtype):
    conv = L.conv3d(12, 12, kernel, stride, padding, groups=12)
    assert conv.weight.shape[:2] == (12, 1)
    x = torch.randn(2, 12, 6, 9, 9, generator=torch.Generator().manual_seed(5))
    want = F.conv3d(x.to(dtype), conv.weight.to(dtype), None, stride,
                    padding, 1, 12)
    conv.compute_dtype = dtype  # a float32 master, cast at the call
    with torch.no_grad():
        got = conv(x)
    assert got.dtype == dtype
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("kernel,stride,padding", [
    (3, (1, 2, 2), 1), ((5, 1, 1), 1, (2, 0, 0))])
def test_channelwise_bf16_gradients_on_the_cpu(kernel, stride, padding):
    """models/x3d.channelwise on a CPU bfloat16 channels-last input (the
    port's default compute dtype with --device cpu) against F.conv3d in
    float32 on the same bfloat16-rounded operands: forward, the input's and
    the float32 master weight's gradients."""
    g = torch.Generator().manual_seed(6)
    conv = L.conv3d(24, 24, kernel, stride, padding, groups=24)
    conv.compute_dtype = torch.bfloat16
    x = torch.randn(2, 24, 4, 16, 16, generator=g).to(
        torch.bfloat16, memory_format=torch.channels_last_3d)
    x.requires_grad_(True)
    x32 = x.detach().float().requires_grad_(True)
    w32 = conv.weight.detach().to(torch.bfloat16).float().requires_grad_(True)
    with torch.enable_grad():
        y = channelwise(conv, x)
        assert y.dtype == torch.bfloat16
        dy = torch.randn(y.shape, generator=g).to(torch.bfloat16)
        dx, dw = torch.autograd.grad(y, (x, conv.weight), dy)
        want = F.conv3d(x32, w32, None, stride, padding, 1, 24)
        dx32, dw32 = torch.autograd.grad(want, (x32, w32), dy.float())
    # each output and each gradient rounded to bfloat16 once: 2^-8 of its
    # size; the fault this guards against reads as large as the gradient
    for got, ref in ((y, want), (dx, dx32), (dw, dw32)):
        err = float((got.detach().float() - ref).norm() / ref.norm())
        assert err < 2 ** -8, err


def test_spans_of_a_forward():
    model = _loaded(_params())
    x = _batch()[0]
    profiler.reset()
    try:
        with torch.no_grad():
            model.train()(x)
            model.eval()(x)
        totals = profiler.registry().totals()
    finally:
        profiler.reset()
    assert totals["conv.depthwise"][0] == 2 * 27
    assert totals["se_swish"][0] == 2 * 26
    assert totals["bn.stats"][0] == 84  # the train-mode forward's alone


def test_parameter_count_and_widths():
    model = _model()
    backbone = sum(p.numel() for p in model.model.parameters())
    head = sum(p.numel() for p in model.output2emb_proj.parameters())
    assert backbone == 2974722
    assert head == 2048 * 2048 + 2048 + 2048 * 300 + 300
    assert backbone + head == 7785774
    assert [round_width(w, 1 / 16) for w in (54, 108, 216, 432)] == list(
        ref.SE_WIDTHS)
    convs = [m for m in model.model.modules() if isinstance(m, L.Conv3d)]
    channelwise = [m for m in convs if m.groups > 1]
    assert len(channelwise) == 27
    assert all(m.groups == m.in_channels == m.out_channels
               for m in channelwise)
    assert sum(isinstance(m, L.BatchNorm3d) for m in model.modules()) == 84


def test_routing_and_tensor_parallel_width(capsys):
    model = _model("convs")
    assert isinstance(model.backbone, X3D) and model.backbone.remat == \
        "convs"
    assert model.head == "mlp" and model.dropout_rate == 0.0
    assert capsys.readouterr().err == ""
    assert model.output2emb_proj.layers[0].in_features == X3D.feature_dim
    check_tensor_parallel(Config(network="x3d_m"), 4)
    # 2048 outputs of fc1: a model axis of 3 does not divide them, nor 6;
    # VideoResNet's 512 would have let 4 and refused 3 alike, so 2048 / 16
    with pytest.raises(ValueError, match="2048 outputs"):
        check_tensor_parallel(Config(network="x3d_m"), 3)
    with pytest.raises(ValueError, match="512 outputs"):
        check_tensor_parallel(Config(network="r2plus1d_18"), 3)


def test_cli_trains_evaluates_and_checkpoints(tmp_path):
    from zeroshotvideoclassification_tpu_torch.cli.main import main

    args = ["--dataset", "synthetic", "--class_total", "8",
            "--train_samples", "8", "--bs", "4", "--size", "32",
            "--clip_len", "4", "--device", "cpu", "--compute_dtype",
            "float32", "--nopretrained", "--no-progressbar", "--save_path",
            str(tmp_path), "--network", "x3d_m", "--checkpoint_every", "1"]
    summary = main(args + ["--n_epochs", "1"])
    assert math.isfinite(summary["best_accuracy"])
    last = list(tmp_path.rglob("last.npz"))
    assert len(last) == 1
    import numpy as np

    with np.load(last[0]) as f:
        keys = set(f.files)
    assert "params::backbone/x3d/blocks/0/conv/conv_xy/weight" in keys
    assert ("model_state::backbone/x3d/blocks/4/res_blocks/6/branch2/"
            "norm_c/running_var") in keys
    summary = main(args + ["--n_epochs", "2", "--resume", "auto"])
    assert math.isfinite(summary["best_accuracy"])


def test_infer_cli_and_engine_serve_it(tmp_path, capsys):
    """--network x3d_m through cli/infer and the serving engine: a
    checkpoint of seeded weights (the port's writer), loaded by both into
    X3D-M; one engine request and one POST /classify rank the clips as the
    CLI does."""
    import json
    import urllib.request

    import numpy as np

    from torch_helpers import synthetic_clip
    from zeroshotvideoclassification_tpu_torch.cli import infer
    from zeroshotvideoclassification_tpu_torch.serve import (
        InferenceEngine,
        start_server,
    )
    from zeroshotvideoclassification_tpu_torch.train.checkpoint import (
        save_checkpoint,
    )
    from zeroshotvideoclassification_tpu_torch.train.step import TrainState

    model = _loaded(_params())
    ckpt = str(tmp_path / "x3d.npz")
    save_checkpoint(ckpt, TrainState(model, make_optimizer(
        model.parameters(), 1e-3)), epoch=1, accuracy=0.0)
    paths = []
    for i in range(3):
        paths.append(str(tmp_path / f"clip{i}.npy"))
        np.save(paths[-1], synthetic_clip(i, 12, 64, 86))
    classes = ["playing guitar", "riding a horse", "washing dishes",
               "juggling balls"]
    argv = ["--videos", *paths, "--classes", *classes,
            "--synthetic_word2vec", "--weights", ckpt, "--network",
            "x3d_m", "--n_clips", "2", "--clip_len", str(CLIP), "--size",
            str(SIZE), "--compute_dtype", "float32", "--device", "cpu"]
    results = infer.main(argv)
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert lines == results and len(results) == 3
    _, class_embed = infer.resolve_classes(
        infer.build_arg_parser().parse_args(argv))
    engine = InferenceEngine(classes, class_embed, network="x3d_m",
                             weights=ckpt, n_clips=2, clip_len=CLIP,
                             size=SIZE, max_batch=4,
                             compute_dtype="float32", device="cpu")
    server, service = start_server(engine, port=0, max_wait_s=0.05)
    try:
        served = engine._scoring[1][0]
        assert isinstance(served.backbone, X3D)
        for k, v in model.state_dict().items():
            assert torch.equal(served.state_dict()[k].cpu(), v), k
        req = urllib.request.Request(
            f"http://127.0.0.1:{server.server_address[1]}/classify",
            data=json.dumps({"videos": paths}).encode(), method="POST")
        with urllib.request.urlopen(req, timeout=120) as r:
            posted = json.loads(r.read())["results"]
        for got in (engine.classify(paths), posted):
            assert [r["top_class"] for r in got] == [
                r["top_class"] for r in results]
            for g, w in zip(got, results):
                assert [t["class"] for t in g["topk"]] == [
                    t["class"] for t in w["topk"]]
                np.testing.assert_allclose(
                    [t["similarity"] for t in g["topk"]],
                    [t["similarity"] for t in w["topk"]], atol=1e-4)
    finally:
        server.shutdown()
        server.server_close()
        service.close()
        engine.close()
