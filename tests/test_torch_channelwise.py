"""X3D's channel-wise conv op (ops/channelwise_conv.py) on the CPU: its
plain version (forward, data and weight gradient through the op) against
F.conv3d in float64 over the same rounded operands at each kernel, stride
and vector width X3D-M takes, gradcheck in float64, the refusals and the
dispatch; the launch plans over X3D-M's 27 shapes (derived from the model
itself); and the CUDA kernels' index and summation schemes
(csrc/channelwise_conv.cu) walked in numpy under those plans against the
plain version. The `cuda` tests hold each kernel to the plain version on
the card at all 27 shapes, at fewer clips and frames, and skip here."""

import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from torch_helpers import bf16_ulps, x3d_channelwise_shapes
from zeroshotvideoclassification_tpu_torch.config import Config
from zeroshotvideoclassification_tpu_torch.models import get_network
from zeroshotvideoclassification_tpu_torch.models import x3d
from zeroshotvideoclassification_tpu_torch.ops import channelwise_conv as cc
from zeroshotvideoclassification_tpu_torch.ops.channelwise_conv import (
    TILES,
    channelwise_conv3d,
    channelwise_dgrad_cuda,
    channelwise_dgrad_plain,
    channelwise_fwd_cuda,
    channelwise_fwd_plain,
    channelwise_wgrad_cuda,
    channelwise_wgrad_plain,
    gather_plan,
    wgrad_plan,
)

# (kernel, stride, padding) of each kind
CONVS = {0: ((3, 3, 3), (1, 1, 1), (1, 1, 1)),
         1: ((3, 3, 3), (1, 2, 2), (1, 1, 1)),
         2: ((5, 1, 1), (1, 1, 1), (2, 0, 0))}
CL = torch.channels_last_3d
SOURCE = (Path(cc.__file__).resolve().parent.parent / "csrc"
          / "channelwise_conv.cu")


def _operands(c, kind, dtype, shape=(2, 5, 10, 12), seed=0):
    """x [N, C, T, H, W] in channels-last-3d memory (dtype), a float32
    master weight and dy of the output's shape (dtype)."""
    g = torch.Generator().manual_seed(seed)
    k, s, p = CONVS[kind]
    n, t, h, w = shape
    x = torch.randn(n, c, t, h, w, generator=g).to(dtype, memory_format=CL)
    weight = torch.randn(c, 1, *k, generator=g) / math.sqrt(math.prod(k))
    out = cc.output_shape(x.shape, weight.shape, s, p)
    dy = torch.randn(out, generator=g).to(dtype, memory_format=CL)
    return x, weight, dy


def _ref64(x, weight, dy, kind):
    """F.conv3d and its two gradients in float64 over x, dy and the weight
    rounded to x's dtype."""
    _, s, p = CONVS[kind]
    c = x.shape[1]
    x64 = x.double().requires_grad_(True)
    w64 = weight.to(x.dtype).double().requires_grad_(True)
    with torch.enable_grad():
        y = F.conv3d(x64, w64, None, s, p, 1, c)
        dx, dw = torch.autograd.grad(y, (x64, w64), dy.double())
    return y.detach(), dx, dw


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c", [24, 54, 108])
@pytest.mark.parametrize("kind", [0, 1, 2])
def test_plain_op_matches_float64(kind, c, dtype):
    """y, dx and dW through the op on the CPU against float64: y and dx
    rounded to x's dtype once (float32: its sums), dW the float32 sum. C
    24, 54 and 108 are the kernels' 16-, 4- and 8-byte rows of X3D-M."""
    x, weight, dy = _operands(c, kind, dtype, seed=kind)
    k, s, p = CONVS[kind]
    with torch.enable_grad():
        xr = x.clone().requires_grad_(True)
        wr = weight.clone().requires_grad_(True)
        y = channelwise_conv3d(xr, wr, s, p)
        dx, dw = torch.autograd.grad(y, (xr, wr), dy)
    y = y.detach()
    y64, dx64, dw64 = _ref64(x, weight, dy, kind)
    assert y.dtype == dx.dtype == dtype and dw.dtype == torch.float32
    assert y.shape == y64.shape and dx.shape == x.shape
    assert dw.shape == weight.shape
    ya, dxa, dwa = _ref64(x.abs(), weight.abs(), dy.abs(), kind)
    for got, want, scale in ((y, y64, ya), (dx, dx64, dxa)):
        # float32 sums, then (bf16) half an ulp of one rounding
        err = (got.double() - want).abs() - 1e-6 * scale
        if dtype == torch.bfloat16:
            assert bf16_ulps(want + err.clamp_min(0), want) <= 0.5 + 1e-9
        else:
            assert float(err.max()) <= 0.0
    assert float(((dw.double() - dw64).abs() - 1e-6 * dwa).max()) <= 0.0
    assert y.is_contiguous(memory_format=CL)


@pytest.mark.parametrize("kind", [0, 1, 2])
def test_gradcheck_in_float64(kind):
    x, weight, _ = _operands(4, kind, torch.float64, (1, 3, 5, 4), seed=3)
    k, s, p = CONVS[kind]
    with torch.enable_grad():
        assert torch.autograd.gradcheck(
            lambda a, b: channelwise_conv3d(a, b, s, p),
            (x.detach().requires_grad_(True),
             weight.double().requires_grad_(True)))


def test_plain_is_f_conv3d_in_float32():
    """In float32 the plain forward is F.conv3d itself, bit for bit."""
    x, weight, _ = _operands(24, 0, torch.float32)
    _, s, p = CONVS[0]
    assert torch.equal(channelwise_fwd_plain(x, weight, s, p),
                       F.conv3d(x, weight, None, s, p, 1, 24))


def test_refusals_and_dispatch():
    x, weight, dy = _operands(24, 0, torch.float32)
    with pytest.raises(ValueError, match="no bias"):
        channelwise_conv3d(x, weight, 1, 1, bias=torch.zeros(24))
    with pytest.raises(ValueError, match="kernel"):
        channelwise_conv3d(x, weight[:, :, :, :, :1], 1, 1)
    with pytest.raises(ValueError, match="stride"):
        channelwise_conv3d(x, weight, 2, 1)
    with pytest.raises(ValueError, match="padding"):
        channelwise_conv3d(x, weight, 1, 0)
    with pytest.raises(ValueError, match="weight must be"):
        channelwise_conv3d(x, weight[:12], 1, 1)
    with pytest.raises(ValueError, match="needs CUDA"):
        channelwise_fwd_cuda(x, weight, 1, 1)
    with pytest.raises(ValueError, match="needs CUDA"):
        channelwise_dgrad_cuda(dy, weight, x.shape, 1, 1)
    with pytest.raises(ValueError, match="needs CUDA"):
        channelwise_wgrad_cuda(x, dy, weight.shape, 1, 1)
    with pytest.raises(ValueError, match="whole 32-bit words"):
        cc.words(27, torch.bfloat16)
    with pytest.raises(ValueError, match="no channel-wise conv for device"):
        channelwise_conv3d(x.to("meta"), weight.to("meta"), 1, 1)
    before = (channelwise_fwd_cuda.launches,
              channelwise_dgrad_cuda.launches,
              channelwise_wgrad_cuda.launches)
    with torch.enable_grad():
        xr = x.clone().requires_grad_(True)
        wr = weight.clone().requires_grad_(True)
        channelwise_conv3d(xr, wr, 1, 1).sum().backward()
    assert (channelwise_fwd_cuda.launches, channelwise_dgrad_cuda.launches,
            channelwise_wgrad_cuda.launches) == before
    assert xr.grad is not None and wr.grad is not None


def test_x3d_takes_the_op_at_its_27_shapes(monkeypatch):
    """A forward of X3D-M calls the op 27 times, at the helper's shapes,
    with the float32 master weight and x in the compute dtype."""
    seen = []

    def spy(x, weight, stride, padding, bias=None):
        seen.append((tuple(x.shape), tuple(weight.shape[2:]),
                     tuple(stride), tuple(padding), x.dtype, weight.dtype))
        return channelwise_conv3d(x, weight, stride, padding, bias)

    monkeypatch.setattr(x3d, "channelwise_conv3d", spy)
    model = get_network(Config(network="x3d_m", clip_len=4, size=32))
    model.set_compute_dtype(torch.bfloat16, masters=True)
    model = model.to(memory_format=CL)
    with torch.no_grad():
        model.eval()(torch.rand(1, 1, 4, 32, 32, 3))
    want = x3d_channelwise_shapes(1, 4, 32)
    assert [s[:4] for s in seen] == [tuple(map(tuple, w)) for w in want]
    assert {s[4:] for s in seen} == {(torch.bfloat16, torch.float32)}


# ------------------------------------------------------------- plans ----

def _tiles_in_source():
    text = SOURCE.read_text()
    out = {}
    for name, key in (("kFwdTiles", "fwd"), ("kDgradTiles", "dgrad"),
                      ("kWgradTiles", "wgrad")):
        m = re.search(name + r"\[3\]\[2\] = \{(.*?)\};", text)
        out[key] = tuple(tuple(int(v) for v in pair.split(","))
                         for pair in re.findall(r"\{(\d+, \d+)\}", m.group(1)))
    return out


def test_tiles_mirror_the_source():
    assert _tiles_in_source() == TILES


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plans_over_x3d_m_shapes(dtype):
    """At the train cell's 64 clips of 16x224x224: each gather covers every
    output with its threads; each weight gradient keeps a few hundred
    partials, whole slabs of at most 32 words (54 / 108 / 216 / 432 bf16
    channels in 27-word slabs), blocks of at most 256 threads and a few KiB
    of shared memory."""
    for shape, k, s, p in x3d_channelwise_shapes(64, 16, 224):
        kind = cc.kind((shape[1], 1, *k), s, p)
        out = cc.output_shape(shape, (shape[1], 1, *k), s, p)
        cw = cc.words(shape[1], dtype)
        for which in ("fwd", "dgrad"):
            thw = out[2:] if which == "fwd" else shape[2:]
            plan = gather_plan(64, thw, cw, kind, which)
            rh, rw = TILES[which][kind]
            assert plan["threads"] >= 64 * thw[1] * thw[2] * cw / (rh * rw)
            assert plan["blocks"] * cc.GATHER_THREADS >= plan["threads"]
        plan = wgrad_plan(64, out[2:], cw, kind)
        assert plan["slabs"] * plan["csw"] >= cw
        assert plan["csw"] <= cc.SLAB_WORDS
        assert plan["csw"] * plan["lanes"] <= cc.THREADS
        assert plan["slabs"] * plan["parts"] <= 300
        assert plan["parts"] * plan["lanes"] <= plan["items"] + plan["lanes"]
        taps = math.prod(k)
        assert 4 * plan["csw"] * (2 if dtype == torch.bfloat16 else 1) \
            * taps <= 8 * 1024
        if dtype == torch.bfloat16 and shape[1] >= 54:
            assert plan["csw"] == 27 and cw % 27 == 0


# --------------------------------- the kernels' schemes, walked in numpy ----

def _axis(k, s, r, transposed):
    """csrc/channelwise_conv.cu's Axis: (count, at[i][d], base(o0))."""
    p = k // 2

    def raw(i, d):
        if transposed:
            q = i + p - d
            return q // s if q % s == 0 else None
        return i * s + d - p

    vals = [raw(i, d) for i in range(r) for d in range(k)
            if raw(i, d) is not None]
    lo = min(vals)
    at = [[-1 if raw(i, d) is None else raw(i, d) - lo for d in range(k)]
          for i in range(r)]
    return (max(vals) - lo + 1, at,
            lambda o0: (o0 // s if transposed else o0 * s) + lo)


def _gather_walk(src, w, kind, transposed, out_thw):
    """The gather kernel's loops over [N, T, H, W, C] float64 arrays, every
    clip and channel at once: per tile of (rh, rw) outputs, source frames
    in order into KT rolling accumulators, a frame written once whole.
    Outputs no thread writes stay NaN."""
    (kt, kh, kw), s, _ = CONVS[kind]
    s = s[1]
    rh, rw = TILES["dgrad" if transposed else "fwd"][kind]
    nr, at_h, base_h = _axis(kh, s, rh, transposed)
    nc, at_w, base_w = _axis(kw, s, rw, transposed)
    pt = kt // 2
    n, ts, hs, ws, c = src.shape
    to, ho, wo = out_thw
    out = np.full((n, to, ho, wo, c), np.nan)
    for hb in range(-(-ho // rh)):
        for wb in range(-(-wo // rw)):
            oh0, ow0 = hb * rh, wb * rw
            r0, c0 = base_h(oh0), base_w(ow0)
            acc = np.zeros((kt, rh, rw, n, c))
            for t in range(to + kt - 1 - pt):
                if t < ts:
                    fr = np.zeros((nr, nc, n, c))
                    for r in range(nr):
                        for q in range(nc):
                            if 0 <= r0 + r < hs and 0 <= c0 + q < ws:
                                fr[r, q] = src[:, t, r0 + r, c0 + q]
                    for i, dh, k, dw, dt in np.ndindex(rh, kh, rw, kw, kt):
                        r, q = at_h[i][dh], at_w[k][dw]
                        if r < 0 or q < 0:
                            continue
                        j = dt if transposed else kt - 1 - dt
                        acc[j, i, k] += fr[r, q] * w[:, dt, dh, dw]
                o = t + pt - (kt - 1)
                if o >= 0:
                    for i, k in np.ndindex(rh, rw):
                        if oh0 + i < ho and ow0 + k < wo:
                            out[:, o, oh0 + i, ow0 + k] = acc[0, i, k]
                acc = np.concatenate([acc[1:], np.zeros_like(acc[:1])])
    return out


def _wgrad_walk(x, dy, kind, plan):
    """The weight gradient's loops: items (tiles of (rh, rw) dy positions
    of one clip) dealt to `lanes` lanes of `parts` blocks, each walking the
    frames with a rolling window of KT dy frames; a block's lanes added in
    lane order, its partial, the partials added in order. -> [C, KT, KH,
    KW] float64."""
    (kt, kh, kw), s, _ = CONVS[kind]
    s = s[1]
    rh, rw = plan["rh"], plan["rw"]
    nr, at_h, base_h = _axis(kh, s, rh, False)
    nc, at_w, base_w = _axis(kw, s, rw, False)
    pt = kt // 2
    n, ts, hs, ws, c = x.shape
    _, to, ho, wo, _ = dy.shape
    hbs, wbs = -(-ho // rh), -(-wo // rw)
    lanes, parts = plan["lanes"], plan["parts"]
    partials = []
    for b in range(parts):
        block = np.zeros((kt, kh, kw, c))
        for lane in range(lanes):
            acc = np.zeros((kt, kh, kw, c))
            for item in range(b * lanes + lane, n * hbs * wbs,
                              parts * lanes):
                wb, rest = item % wbs, item // wbs
                hb, m = rest % hbs, rest // hbs
                oh0, ow0 = hb * rh, wb * rw
                r0, c0 = base_h(oh0), base_w(ow0)
                win = np.zeros((kt, rh, rw, c))
                for t in range(-pt, ts):
                    win = np.concatenate([win[1:], np.zeros_like(win[:1])])
                    tn = t + pt
                    for i, k in np.ndindex(rh, rw):
                        if tn < to and oh0 + i < ho and ow0 + k < wo:
                            win[-1, i, k] = dy[m, tn, oh0 + i, ow0 + k]
                    if t < 0:
                        continue
                    fr = np.zeros((nr, nc, c))
                    for r in range(nr):
                        for q in range(nc):
                            if 0 <= r0 + r < hs and 0 <= c0 + q < ws:
                                fr[r, q] = x[m, t, r0 + r, c0 + q]
                    for i, dh, k, dw, dt in np.ndindex(rh, kh, rw, kw, kt):
                        acc[dt, dh, dw] += (fr[at_h[i][dh], at_w[k][dw]]
                                            * win[kt - 1 - dt, i, k])
            block += acc
        partials.append(block)
    return np.moveaxis(sum(partials), -1, 0)


def _ndhwc(t):
    return t.permute(0, 2, 3, 4, 1).double().numpy()


@pytest.mark.parametrize("hw", [(8, 8), (7, 9)])
@pytest.mark.parametrize("kind", [0, 1, 2])
def test_gather_schemes_walked_in_numpy(kind, hw):
    """The forward's and the data gradient's index schemes (tiles, the
    transposed gather's taps, the frames' rolling accumulators) give the
    plain version's y and dx in float64, every output written once; odd
    sizes leave ragged tiles."""
    x, weight, dy = _operands(4, kind, torch.float64, (2, 5, *hw), seed=7)
    k, s, p = CONVS[kind]
    w = weight.double().reshape(4, *k).numpy()
    y = _gather_walk(_ndhwc(x), w, kind, False, dy.shape[2:])
    np.testing.assert_allclose(y, _ndhwc(channelwise_fwd_plain(
        x, weight.double(), s, p)), rtol=1e-12, atol=1e-12)
    dx = _gather_walk(_ndhwc(dy), w, kind, True, x.shape[2:])
    np.testing.assert_allclose(dx, _ndhwc(channelwise_dgrad_plain(
        dy, weight.double(), x.shape, s, p, torch.float64)), rtol=1e-12,
        atol=1e-12)


@pytest.mark.parametrize("hw", [(8, 8), (7, 9)])
@pytest.mark.parametrize("kind", [0, 1, 2])
def test_wgrad_scheme_walked_in_numpy(kind, hw):
    """The weight gradient's items, lanes, blocks and rolling dy window give
    the plain version's dW in float64, at a plan with several blocks and
    lanes (the items of 2 clips over few SMs)."""
    x, weight, dy = _operands(4, kind, torch.float64, (2, 5, *hw), seed=8)
    k, s, p = CONVS[kind]
    plan = {**wgrad_plan(2, dy.shape[2:], 4, kind), "lanes": 3,
            "parts": 2}  # several blocks and lanes, few items each
    got = _wgrad_walk(_ndhwc(x), _ndhwc(dy), kind, plan)
    want = channelwise_wgrad_plain(x, dy, weight.shape, s, p)
    np.testing.assert_allclose(got, want.reshape(4, *k).numpy(), rtol=1e-12,
                               atol=1e-12)


# ---------------------------------------------------------------- card ----

def _unique_x3d_shapes(clips, frames):
    seen = []
    for shape in x3d_channelwise_shapes(clips, frames, 224):
        if shape not in seen:
            seen.append(shape)
    return seen


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU and nvcc (run on the card)")
    torch.backends.cudnn.allow_tf32 = False
    with torch.enable_grad():
        yield torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", _unique_x3d_shapes(2, 6),
                         ids=lambda s: "x".join(map(str, s[0])) + "-"
                         + "".join(map(str, s[1])) + "-s"
                         + "".join(map(str, s[2])))
def test_kernels_match_plain_at_x3d_m_shapes(cuda, shape, dtype):
    """Each of X3D-M's shapes (2 clips of 6 frames at its 224 clip): the
    forward and the data gradient within a bf16 ulp (or float32 sums) of
    the plain version on the same card, the weight gradient within float32
    sums of it, and the same bits from two calls."""
    xs, k, s, p = shape
    g = torch.Generator(device=cuda).manual_seed(11)
    x = torch.randn(xs, device=cuda, generator=g).to(dtype, memory_format=CL)
    weight = torch.randn(xs[1], 1, *k, device=cuda, generator=g)
    out = cc.output_shape(xs, weight.shape, s, p)
    dy = torch.randn(out, device=cuda, generator=g).to(dtype,
                                                       memory_format=CL)
    y = channelwise_fwd_cuda(x, weight, s, p)
    dx = channelwise_dgrad_cuda(dy, weight, xs, s, p)
    dw = channelwise_wgrad_cuda(x, dy, weight.shape, s, p)
    dw2 = channelwise_wgrad_cuda(x, dy, weight.shape, s, p)
    assert torch.equal(dw, dw2)
    assert y.is_contiguous(memory_format=CL)
    assert dx.is_contiguous(memory_format=CL)
    wa = weight.abs()
    for got, want, scale in (
            (y, channelwise_fwd_plain(x, weight, s, p),
             channelwise_fwd_plain(x.abs(), wa, s, p)),
            (dx, channelwise_dgrad_plain(dy, weight, xs, s, p, dtype),
             channelwise_dgrad_plain(dy.abs(), wa, xs, s, p, dtype))):
        err = (got.float() - want.float()).abs()
        if dtype == torch.bfloat16:  # one rounding each, of float32 sums
            ulp = torch.exp2(torch.floor(torch.log2(torch.clamp_min(
                want.float().abs(), 2.0 ** -126))) - 7)
            assert bool((err <= ulp + 1e-5 * scale.float()).all())
        else:
            assert bool((err <= 1e-5 * scale.float() + 1e-30).all())
    want = channelwise_wgrad_plain(x, dy, weight.shape, s, p)
    scale = channelwise_wgrad_plain(x.abs(), dy.abs(), weight.shape, s, p)
    assert bool(((dw - want).abs() <= 2e-5 * scale).all())


@pytest.mark.cuda
def test_op_through_autograd_on_the_card(cuda):
    """The op on CUDA: one launch of each kernel per call, gradients in x's
    dtype and float32, a strided dy made channels-last."""
    xs, k, s, p = x3d_channelwise_shapes(2, 4, 64)[1]
    x = torch.randn(xs, device=cuda).to(torch.bfloat16,
                                         memory_format=CL).requires_grad_()
    weight = torch.randn(xs[1], 1, *k, device=cuda, requires_grad=True)
    before = (channelwise_fwd_cuda.launches, channelwise_dgrad_cuda.launches,
              channelwise_wgrad_cuda.launches)
    y = channelwise_conv3d(x, weight, s, p)
    dy = torch.randn(y.shape[::-1], device=cuda).to(torch.bfloat16)
    dy = dy.permute(4, 3, 2, 1, 0)  # no channels-last-3d view
    dx, dw = torch.autograd.grad(y, (x, weight), dy)
    assert (channelwise_fwd_cuda.launches - before[0],
            channelwise_dgrad_cuda.launches - before[1],
            channelwise_wgrad_cuda.launches - before[2]) == (1, 1, 1)
    assert dx.dtype == torch.bfloat16 and dw.dtype == torch.float32
    d = dy.contiguous(memory_format=CL)
    assert torch.equal(dx, channelwise_dgrad_cuda(d, weight, xs, s, p))
    assert torch.equal(dw, channelwise_wgrad_cuda(x.detach(), d,
                                                  weight.shape, s, p))
