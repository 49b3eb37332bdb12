"""The CUDA kernels on the card: each against its plain PyTorch version on
the same CUDA tensors, the wrappers' refusals, and the port's model and
engine running through the kernels.

Every test here needs an NVIDIA GPU with nvcc and skips without one. The
module imports no JAX, so on a machine without it run it without the
repository's conftest (which sets up JAX):

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""

import gc

import numpy as np
import pytest
import torch

from zeroshotvideoclassification_tpu_torch.data.transform_params import (
    make_transform_params,
    resample_indices,
    resized_dims,
)
from zeroshotvideoclassification_tpu_torch.ops.bn_cuda import (
    bn_apply_relu,
    bn_apply_relu_bwd_cuda,
    bn_apply_relu_bwd_plain,
    bn_apply_relu_cuda,
    bn_apply_relu_plain,
    bwd_plan,
    fold_affine,
    fwd_plan,
)
from zeroshotvideoclassification_tpu_torch.data.stillimages import (
    CH_OFFSET,
    CH_SCALE,
    camera_motion_trajectory,
    motion_resample_indices,
)
from zeroshotvideoclassification_tpu_torch.ops.resample import (
    fused_image_motion_transform,
    fused_video_transform,
)
from zeroshotvideoclassification_tpu_torch.ops.resample_cuda import (
    fused_image_motion_transform_cuda,
    fused_video_transform_cuda,
    image_motion_transform,
    transform_plan,
    video_transform,
)
from zeroshotvideoclassification_tpu_torch.ops.temporal_conv import (
    temporal_conv3,
    temporal_conv3_cuda,
    temporal_conv3_plain,
    tile_plan,
)
from torch_helpers import (
    bf16_ulps,
    calibrate_bn,
    copy_bn,
    seed_adam,
    synthetic_clip,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU and nvcc (run on the card)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with torch.enable_grad():  # whatever another module left switched off
        yield torch.device("cuda")


def _transform_args(dev, b=3, t=5, hc=226, wc=226, seed=0):
    rng = np.random.default_rng(seed)
    canvas = rng.integers(0, 256, (b, t, hc, wc, 3), dtype=np.uint8)
    p = make_transform_params(np.array([[hc - 10, wc - 6]] * b), 112,
                              False, rng)
    p.flip[:] = np.arange(b) % 2 == 1
    idx = resample_indices(p, 112).astuple()
    return [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
            for a in (canvas, *idx)]


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_k1_matches_plain(cuda, out_dtype):
    args = _transform_args(cuda)
    want = fused_video_transform(*args, out_dtype=out_dtype)
    before = fused_video_transform_cuda.launches
    got = video_transform(*args, out_dtype=out_dtype)
    torch.cuda.synchronize()
    assert fused_video_transform_cuda.launches == before + 1
    assert got.dtype == out_dtype and got.shape == (3, 5, 112, 112, 3)
    if out_dtype == torch.float32:
        torch.testing.assert_close(got, want, atol=2e-6, rtol=0)
    else:
        assert bf16_ulps(got, want) <= 1.0


def test_k1_odd_canvas_and_refusals(cuda):
    args = _transform_args(cuda, b=2, t=3, hc=131, wc=173, seed=1)
    got = fused_video_transform_cuda(*args)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, fused_video_transform(*args), atol=2e-6,
                               rtol=0)
    with pytest.raises(ValueError, match="contiguous"):
        fused_video_transform_cuda(args[0].transpose(2, 3), *args[1:])
    with pytest.raises(ValueError, match="y1"):
        fused_video_transform_cuda(args[0], args[1], args[2].cpu(),
                                   *args[3:])


def _assert_k1(args, out_dtype=torch.float32):
    got = fused_video_transform_cuda(*args, out_dtype=out_dtype)
    torch.cuda.synchronize()
    want = fused_video_transform(*args, out_dtype=out_dtype)
    if out_dtype == torch.float32:
        torch.testing.assert_close(got, want, atol=2e-6, rtol=0)
    else:
        assert bf16_ulps(got, want) <= 1.0
    return got


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_k1_bands_at_the_canvas_edge(cuda, out_dtype):
    """Crops at the bottom-right corner and at the top-left (first and last
    bands touch the canvas's first and last rows; the clamped second tap
    repeats the last row), flipped and not."""
    rng = np.random.default_rng(4)
    b, hc, wc = 4, 150, 190
    canvas = rng.integers(0, 256, (b, 3, hc, wc, 3), dtype=np.uint8)
    p = make_transform_params(np.array([[hc, wc]] * b), 112, False, rng)
    hr, wr, _ = resized_dims(hc, wc, 128)
    p.crop_ij[:] = [[hr - 112, wr - 112], [0, 0], [hr - 112, 0], [0, 0]]
    p.flip[:] = [False, True, True, False]
    idx = resample_indices(p, 112)
    assert int(idx.y1.max()) == hc - 1 and int(idx.y0.min()) == 0
    args = [torch.from_numpy(np.ascontiguousarray(a)).to(cuda)
            for a in (canvas, *idx.astuple())]
    _assert_k1(args, out_dtype)


@pytest.mark.parametrize("hc", [131, 400])
def test_k1_non_monotone_taps_in_pieces(cuda, hc):
    """Row taps in random order, second taps anywhere in the canvas: bands
    whose span exceeds the staging area are done in pieces, and output rows
    whose two taps lie far apart stage just those two rows."""
    args = _transform_args(cuda, b=3, t=2, hc=hc, wc=173, seed=5)
    g = torch.Generator(device=cuda).manual_seed(5)
    perm = torch.randperm(112, device=cuda, generator=g)
    for j in (1, 2, 3):
        args[j] = args[j][:, perm].contiguous()
    args[2] = torch.randint(0, hc, args[2].shape, device=cuda,
                            generator=g, dtype=torch.int32)
    assert transform_plan(3, 2, hc, 173, 112, 4)["stage_rows"] < hc
    for dt in (torch.float32, torch.bfloat16):
        _assert_k1(args, dt)


def test_k1_canvas_off_the_16_byte_grid(cuda):
    """A canvas that is a contiguous view a few bytes into its buffer: the
    staging copies take their cut pieces at other places, the result does
    not change by a bit."""
    args = _transform_args(cuda, b=2, t=3, hc=131, wc=173, seed=6)
    want = fused_video_transform_cuda(*args)
    for off in (1, 5, 13):
        buf = torch.empty(args[0].numel() + 16, dtype=torch.uint8,
                          device=cuda)
        view = buf[off:off + args[0].numel()].view(args[0].shape)
        view.copy_(args[0])
        assert view.data_ptr() % 16 != 0 and view.is_contiguous()
        assert torch.equal(_assert_k1([view, *args[1:]]), want)


@pytest.mark.parametrize("hc,wc", [(40, 16000), (2000, 8000)])
def test_k1_on_canvases_too_wide_for_a_tall_band(cuda, hc, wc):
    """Canvases 16000 and 8000 pixels wide: the plan shrinks the band to
    what fits 227 KB of shared memory (2 rows a band), or, where a band's
    span cannot fit (2000 rows tall), keeps 16 rows and stages each band in
    pieces of 8 canvas rows."""
    args = _transform_args(cuda, b=2, t=2, hc=hc, wc=wc, seed=9)
    plan = transform_plan(2, 2, hc, wc, 112, 4)
    assert (plan["whole_span"], plan["band_rows"]) == (
        (True, 2) if hc == 40 else (False, 16))
    for dt in (torch.float32, torch.bfloat16):
        _assert_k1(args, dt)


def test_k1_at_the_grid_limit(cuda):
    """B * T = 65535 frames (grid.y's limit) of a small canvas; one more
    raises."""
    rng = np.random.default_rng(8)
    b, t, hc, wc, s = 5, 13107, 9, 11, 4
    canvas = rng.integers(0, 256, (b, t, hc, wc, 3), dtype=np.uint8)
    p = make_transform_params(np.array([[hc, wc]] * b), s, False, rng)
    args = [torch.from_numpy(np.ascontiguousarray(a)).to(cuda)
            for a in (canvas, *resample_indices(p, s).astuple())]
    assert b * t == 65535
    for dt in (torch.float32, torch.bfloat16):
        _assert_k1(args, dt)
    big = torch.zeros((5, 13108, hc, wc, 3), dtype=torch.uint8, device=cuda)
    with pytest.raises(ValueError, match="65535"):
        fused_video_transform_cuda(big, *args[1:])


def _motion_args(dev, b=3, t=5, hw=(180, 221), canvas=(200, 230), seed=0,
                 trajectories=None, s=112, shuffle=False):
    rng = np.random.default_rng(seed)
    imgs = np.zeros((b, *canvas, 3), np.uint8)
    imgs[:, :hw[0], :hw[1]] = rng.integers(0, 256, (b, *hw, 3),
                                           dtype=np.uint8)
    idx = []
    for k in range(b):
        traj = (camera_motion_trajectory(hw, s, t, rng)
                if trajectories is None else np.asarray(trajectories))
        idx.append(motion_resample_indices(traj, hw, s))
    taps = [np.stack([idx[k][j] for k in range(b)]) for j in range(6)]
    if shuffle:  # row taps in random order, second row taps anywhere
        perm = rng.permutation(s)
        for j in (0, 1, 2):
            taps[j] = taps[j][..., perm]
        taps[1] = rng.integers(0, canvas[0], taps[1].shape).astype(np.int32)
    return [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
            for a in (imgs, *taps)]


def _assert_k4(args, out_dtype=torch.float32):
    before = fused_image_motion_transform_cuda.launches
    got = fused_image_motion_transform_cuda(*args, CH_SCALE, CH_OFFSET,
                                            out_dtype)
    torch.cuda.synchronize()
    assert fused_image_motion_transform_cuda.launches == before + 1
    want = fused_image_motion_transform(*args, CH_SCALE, CH_OFFSET, out_dtype)
    if out_dtype == torch.float32:
        torch.testing.assert_close(got, want, atol=2e-6, rtol=0)
    else:
        assert bf16_ulps(got, want) <= 1.0
    return got


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_k4_at_the_sun_shape(cuda, out_dtype):
    """The SUN path's shape: 16 images on the 256 x 342 canvas, 16 frames
    of 112 x 112 each, under the plan that stages each band's whole span."""
    args = _motion_args(cuda, b=16, t=16, hw=(240, 330), canvas=(256, 342),
                        seed=3)
    assert transform_plan(16, 16, 256, 342, 112,
                          2 if out_dtype == torch.bfloat16 else 4)[
                              "whole_span"]
    _assert_k4(args, out_dtype)


@pytest.mark.parametrize("hc", [131, 400])
def test_k4_odd_side_and_non_monotone_taps(cuda, hc):
    """An odd output side (97) on an odd canvas, then row taps in random
    order with second taps anywhere in images 131 and 400 rows tall: bands
    whose span exceeds the staging area are done in pieces, and output rows
    whose two taps lie far apart stage just those two rows."""
    args = _motion_args(cuda, b=2, t=3, hw=(120, 150), canvas=(131, 173),
                        seed=4, s=97)
    for dt in (torch.float32, torch.bfloat16):
        _assert_k4(args, dt)
    args = _motion_args(cuda, b=3, t=2, hw=(hc - 5, 170), canvas=(hc, 173),
                        seed=5, shuffle=True)
    assert transform_plan(3, 2, hc, 173, 112, 4)["stage_rows"] < hc
    for dt in (torch.float32, torch.bfloat16):
        _assert_k4(args, dt)


def test_k4_images_off_the_16_byte_grid(cuda):
    """Images that are a contiguous view a few bytes into their buffer: the
    staging copies take their cut pieces at other places, the result does
    not change by a bit."""
    args = _motion_args(cuda, b=2, t=3, seed=6)
    want = fused_image_motion_transform_cuda(*args, CH_SCALE, CH_OFFSET)
    for off in (1, 5, 13):
        buf = torch.empty(args[0].numel() + 16, dtype=torch.uint8,
                          device=cuda)
        view = buf[off:off + args[0].numel()].view(args[0].shape)
        view.copy_(args[0])
        assert view.data_ptr() % 16 != 0 and view.is_contiguous()
        assert torch.equal(_assert_k4([view, *args[1:]]), want)


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_k4_matches_plain(cuda, out_dtype):
    """K4 against its plain version on the card: float32 within 2e-6 (the
    same operations in the same order, no contraction), bf16 within 1 ulp."""
    args = _motion_args(cuda)
    want = fused_image_motion_transform(*args, CH_SCALE, CH_OFFSET, out_dtype)
    before = fused_image_motion_transform_cuda.launches
    got = image_motion_transform(*args, CH_SCALE, CH_OFFSET, out_dtype)
    torch.cuda.synchronize()
    assert fused_image_motion_transform_cuda.launches == before + 1
    assert got.dtype == out_dtype and got.shape == (3, 5, 112, 112, 3)
    if out_dtype == torch.float32:
        torch.testing.assert_close(got, want, atol=2e-6, rtol=0)
    else:
        assert bf16_ulps(got, want) <= 1.0


def test_k4_overhanging_boxes_and_refusals(cuda):
    traj = [[0, 5, 112], [0, 200, 112], [0, 300, 112]]
    args = _motion_args(cuda, b=2, t=3, hw=(100, 400), canvas=(100, 400),
                        trajectories=traj)
    got = fused_image_motion_transform_cuda(*args, CH_SCALE, CH_OFFSET)
    torch.cuda.synchronize()
    torch.testing.assert_close(
        got, fused_image_motion_transform(*args, CH_SCALE, CH_OFFSET),
        atol=2e-6, rtol=0)
    with pytest.raises(ValueError, match="contiguous"):
        fused_image_motion_transform_cuda(
            args[0].transpose(1, 2).contiguous().transpose(1, 2), *args[1:],
            CH_SCALE, CH_OFFSET)
    with pytest.raises(ValueError, match="y1"):
        fused_image_motion_transform_cuda(args[0], args[1], args[2].cpu(),
                                          *args[3:], CH_SCALE, CH_OFFSET)


def _tconv_operands(dev, shape, co, dtype, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    ci = shape[-1]
    x = torch.randn(shape, device=dev, generator=g).to(dtype)
    w = (torch.randn((3, 1, 1, ci, co), device=dev, generator=g)
         / (3 * ci) ** 0.5).to(dtype)
    return x, w


# (x shape [N, T, H, W, Ci], Co): tiles that are whole, ragged in rows, in
# Ci (not a multiple of 16) and in Co (not a multiple of 64), T = 1 and 2
K3_SHAPES = [((2, 4, 8, 8, 32), 64), ((2, 5, 7, 9, 45), 64),
             ((3, 2, 7, 7, 230), 128), ((1, 1, 5, 5, 16), 7),
             ((2, 3, 11, 13, 144), 70)]


@pytest.mark.parametrize("shape,co", K3_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k3_matches_plain(cuda, shape, co, dtype):
    """K3 against its plain version on the card: float32 within atol/rtol
    1e-5 (another summation order over 3 * Ci products of O(1) results),
    bf16 within 2 ulp (both accumulate in float32 and round once)."""
    x, w = _tconv_operands(cuda, shape, co, dtype)
    want = temporal_conv3_plain(x, w)
    before = temporal_conv3_cuda.launches
    got = temporal_conv3(x, w, dtype)
    torch.cuda.synchronize()
    assert temporal_conv3_cuda.launches == before + 1
    assert got.dtype == dtype and got.shape == (*shape[:4], co)
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
    else:
        assert bf16_ulps(got, want) <= 2.0


# bf16 only: (x shape, Co, kernel, staging) of every path of the tensor-core
# kernels: TMA, 4-byte cp.async and 2-byte loads in the resident and in the
# streamed kernel, the resident kernel's bulk copy with a 4- or 2-byte
# re-layout (one and several tiles a frame, the last one short), 7x7 positions with T = 2 (a 64-row
# tile mostly empty), row counts that are no multiple of the tile, Co ragged
# and past one 64-channel tile, a tap split into two groups (Ci 176)
K3_PATHS = [
    ((2, 4, 9, 9, 144), 64, "resident", "tma"),
    ((2, 3, 9, 9, 230), 128, "resident", "cp.async4"),
    ((2, 3, 9, 9, 45), 64, "resident", "scalar"),
    ((2, 3, 12, 12, 230), 128, "resident", "bulk4"),
    ((1, 5, 8, 8, 230), 70, "resident", "bulk4"),
    ((2, 4, 12, 12, 45), 64, "resident", "bulk2"),
    ((1, 1, 8, 8, 45), 64, "resident", "bulk2"),
    ((4, 2, 7, 7, 144), 64, "resident", "tma"),
    ((3, 5, 13, 11, 176), 72, "streamed", "tma"),
    ((2, 3, 9, 9, 288), 128, "streamed", "tma"),
    ((2, 3, 9, 9, 460), 256, "streamed", "cp.async4"),
    ((4, 2, 7, 7, 921), 512, "streamed", "scalar"),
    ((1, 1, 3, 3, 1152), 70, "streamed", "tma"),
]


def _assert_k3_bf16(x, w):
    """The kernel against the plain version at the op's bf16 bar: 2 bf16 ulp
    beyond the float32 bar of 1e-5. Both round one float32 sum of exact
    products to bf16; the sums differ by their order and by the tensor
    cores' truncating adds (~1e-6 for results of O(1)), which is many bf16
    ulp of an output that cancels to 1e-5 and nothing beside one of O(1).
    -> the kernel's result."""
    want = temporal_conv3_plain(x, w)
    got = temporal_conv3_cuda(x, w)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    diff = (got.float() - want.float()).abs()
    assert bf16_ulps((diff - 1e-5).clamp_min(0) + want.float(), want) <= 2.0
    return got


@pytest.mark.parametrize("shape,co,kernel,staging", K3_PATHS)
def test_k3_tensor_core_paths(cuda, shape, co, kernel, staging):
    """Each staging path and both tensor-core kernels against the plain
    version."""
    n, t, h, wd, ci = shape
    plan = tile_plan(n, t, h * wd, ci, co)
    assert (plan["kernel"], plan["staging"]) == (kernel, staging)
    _assert_k3_bf16(*_tconv_operands(cuda, shape, co, torch.bfloat16, seed=3))


@pytest.mark.parametrize("offset,staging", [
    (1, ("scalar", "scalar")), (2, ("cp.async4", "cp.async4")),
    (8, ("tma", "tma"))])
@pytest.mark.parametrize("ci", [144, 288])
def test_k3_takes_a_misaligned_view(cuda, ci, offset, staging):
    """x as a contiguous view `offset` elements into a buffer: 2- and 4-byte
    aligned pointers narrow the staging copies (the plan says which), the
    result does not change by a bit."""
    shape, co = (2, 3, 9, 9, ci), 64
    x, w = _tconv_operands(cuda, shape, co, torch.bfloat16, seed=4)
    buf = torch.empty(x.numel() + 16, dtype=x.dtype, device=cuda)
    view = buf[offset:offset + x.numel()].view(shape)
    view.copy_(x)
    assert view.is_contiguous() and view.data_ptr() % 16 == (2 * offset) % 16
    align = view.data_ptr() & -view.data_ptr()
    plan = tile_plan(2, 3, 81, ci, co, x_align=min(align, 16))
    assert plan["staging"] == staging[0 if ci == 144 else 1]  # resident?
    # the staging path changes how x reaches shared memory and nothing of
    # the arithmetic: bit for bit the aligned call's result
    assert torch.equal(_assert_k3_bf16(view, w), temporal_conv3_cuda(x, w))


@pytest.mark.parametrize("seed", range(12))
def test_k3_at_random_shapes(cuda, seed):
    """Shapes drawn from a seed, small enough for any tile to be ragged in
    every direction (one position, one channel, one frame included): both
    dtypes against the plain version at the op's bars."""
    rng = np.random.default_rng(100 + seed)
    shape = (int(rng.integers(1, 4)), int(rng.integers(1, 6)),
             int(rng.integers(1, 13)), int(rng.integers(1, 13)),
             int(rng.choice([1, 2, 7, 8, 16, 24, 45, 64, 100, 144, 176, 230,
                             256, 264, 288, 300])))
    co = int(rng.choice([1, 5, 8, 63, 64, 65, 128, 140]))
    x, w = _tconv_operands(cuda, shape, co, torch.float32, seed=seed)
    got = temporal_conv3_cuda(x, w)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, temporal_conv3_plain(x, w), atol=1e-5,
                               rtol=1e-5)
    _assert_k3_bf16(x.bfloat16(), w.bfloat16())


def test_k3_gradients_and_refusals(cuda):
    """The op differentiates on the card (forward by the kernel, backward by
    the library convolution's gradient): within 1e-4 of the plain version's
    autograd gradients."""
    x, w = _tconv_operands(cuda, (2, 4, 6, 6, 24), 40, torch.float32)
    leaves = [x.requires_grad_(), w.requires_grad_()]
    g = torch.randn((2, 4, 6, 6, 40), device=cuda)
    got = torch.autograd.grad((temporal_conv3(x, w, torch.float32) * g).sum(),
                              leaves)
    xf, wf = x.float(), w[:, 0, 0].float()
    y = xf @ wf[1]
    y = y + torch.nn.functional.pad(xf[:, :-1] @ wf[0], (0, 0) * 3 + (1, 0))
    y = y + torch.nn.functional.pad(xf[:, 1:] @ wf[2], (0, 0) * 3 + (0, 1))
    want = torch.autograd.grad((y * g).sum(), leaves)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4)
    with pytest.raises(ValueError, match="contiguous"):
        temporal_conv3_cuda(x.detach().transpose(2, 3), w.detach())
    with pytest.raises(ValueError, match="share one of"):
        temporal_conv3_cuda(x.detach(), w.detach().to(torch.bfloat16))


def _bn_operands(dev, shape, dtype, with_res, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    c = shape[-1]
    stats = [torch.rand(c, device=dev, generator=g) + 0.5,
             torch.randn(c, device=dev, generator=g),
             torch.randn(c, device=dev, generator=g),
             torch.rand(c, device=dev, generator=g) * 2.7 + 0.3]
    x = torch.randn(shape, device=dev, generator=g).to(dtype)
    r = (torch.randn(shape, device=dev, generator=g).to(dtype)
         if with_res else None)
    return x, stats, r


@pytest.mark.parametrize("c", [45, 921])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_res", [False, True])
@pytest.mark.parametrize("relu", [True, False])
def test_k2_matches_plain(cuda, c, dtype, with_res, relu):
    x, stats, r = _bn_operands(cuda, (4, 3, 9, 11, c), dtype, with_res)
    want = bn_apply_relu_plain(x, *stats, r, relu)
    before = bn_apply_relu_cuda.launches
    got = bn_apply_relu(x, *stats, r, relu)
    torch.cuda.synchronize()
    assert bn_apply_relu_cuda.launches == before + 1
    assert got.dtype == dtype and got.shape == want.shape
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, atol=2e-6, rtol=0)
    else:
        assert bf16_ulps(got, want) <= 1.0


def test_k2_refusals(cuda):
    x, stats, r = _bn_operands(cuda, (2, 3, 4, 45), torch.bfloat16, True)
    with pytest.raises(ValueError, match="contiguous"):
        bn_apply_relu_cuda(x.transpose(1, 2), *stats)
    with pytest.raises(ValueError, match="residual"):
        bn_apply_relu_cuda(x, *stats, r.float())
    with pytest.raises(ValueError, match="scale"):
        bn_apply_relu_cuda(x, stats[0].cpu(), *stats[1:])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("which", ["x", "residual"])
def test_k2_forward_takes_a_misaligned_view(cuda, dtype, which):
    """x or the residual as a contiguous view one element into a buffer
    (not 16-byte aligned): the plan's one-element path, the aligned call's
    result bit for bit."""
    shape = (4, 3, 9, 11, 230)
    x, stats, r = _bn_operands(cuda, shape, dtype, True)
    want = bn_apply_relu_cuda(x, *stats, r, True)
    ops = {"x": x, "residual": r}
    buf = torch.empty(x.numel() + 8, dtype=dtype, device=cuda)
    view = buf[1:1 + x.numel()].view(shape)
    view.copy_(ops[which])
    assert view.data_ptr() % 16 != 0 and view.is_contiguous()
    ops[which] = view
    assert fwd_plan(x.numel(), 230, x.element_size(), False)["path"] == (
        "scalar")
    got = bn_apply_relu_cuda(ops["x"], *stats, ops["residual"], True)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert torch.equal(got, bn_apply_relu_plain(x, *stats, r, True))


@pytest.mark.parametrize("seed", range(12))
def test_k2_forward_at_random_shapes(cuda, seed):
    """(rows, C) drawn from a seed, down to one row and one channel, where
    the folded view is wider than the tensor and its last row ragged: every
    variant against the plain version (float32 bit for bit: the same
    operations in the same order)."""
    rng = np.random.default_rng(300 + seed)
    c = int(rng.choice([1, 2, 3, 8, 45, 64, 100, 230, 513, 921, 1200]))
    rows = int(rng.choice([1, 2, 7, 63, 500, 4097, 40001]))
    dtype = (torch.float32, torch.bfloat16)[seed % 2]
    relu, with_res = bool(rng.integers(0, 2)), bool(rng.integers(0, 2))
    x, stats, r = _bn_operands(cuda, (rows, c), dtype, with_res, seed=seed)
    x.view(-1)[::31] = float("nan")  # passes the ReLU, as torch.relu's
    plan = fwd_plan(rows * c, c, x.element_size(), True)
    got = bn_apply_relu_cuda(x, *stats, r, relu)
    torch.cuda.synchronize()
    want = bn_apply_relu_plain(x, *stats, r, relu)
    assert torch.equal(got.isnan(), want.isnan()), plan
    ok = ~want.isnan()
    if dtype == torch.float32:
        assert torch.equal(got[ok], want[ok]), plan
    else:
        assert bf16_ulps(got[ok], want[ok]) <= 1.0, plan


def test_k2_forward_constants_equal_torch_rsqrt_bit_for_bit(cuda):
    """The kernel computes a = scale * rsqrt(var + eps) and b = bias -
    mean * a itself. With x = 1, bias = mean = 0 its output is a; with
    x = 0 it is b: both equal fold_affine's PyTorch values bit for bit."""
    c, rows = 921, 64
    g = torch.Generator(cuda).manual_seed(7)
    scale = torch.rand(c, device=cuda, generator=g) * 1.5 + 0.5
    bias = torch.randn(c, device=cuda, generator=g)
    mean = torch.randn(c, device=cuda, generator=g)
    var = torch.rand(c, device=cuda, generator=g) * 2.7 + 1e-3
    zero = torch.zeros_like(mean)
    for eps in (1e-5, 1e-3):
        a, b = fold_affine(scale, bias, mean, var, eps)
        ones = torch.ones((rows, c), device=cuda)
        got_a = bn_apply_relu_cuda(ones, scale, zero, zero, var, None, False,
                                   eps)
        got_b = bn_apply_relu_cuda(ones * 0, scale, bias, mean, var, None,
                                   False, eps)
        torch.cuda.synchronize()
        assert torch.equal(got_a, fold_affine(scale, zero, zero, var,
                                              eps)[0].expand(rows, c))
        assert torch.equal(got_b, b.expand(rows, c))
        x = torch.randn((rows, c), device=cuda, generator=g)
        assert torch.equal(bn_apply_relu_cuda(x, scale, bias, mean, var,
                                              None, False, eps),
                           x * a + b)


def test_k2_forward_is_one_kernel_and_one_allocation(cuda):
    """Under torch.profiler a call of the wrapper is one CUDA kernel (the
    forward's) and no PyTorch op beyond the allocation of y."""
    from torch.profiler import ProfilerActivity, profile

    x, stats, r = _bn_operands(cuda, (2, 4, 14, 14, 230), torch.bfloat16,
                               True)
    bn_apply_relu_cuda(x, *stats, r, True)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        bn_apply_relu_cuda(x, *stats, r, True)
        torch.cuda.synchronize()
    kernels = [e.name for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    assert len(kernels) == 1 and "bn_apply_relu" in kernels[0], kernels
    ops = {e.name for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CPU
           and e.name.startswith("aten::")}
    assert ops <= {"aten::empty_like", "aten::empty_strided",
                   "aten::empty"}, ops


def test_k2_index_past_2_pow_31(cuda):
    """An epilogue of more than 2^31 elements takes the kernel's 64-bit
    index path (the bucket-128 forward's largest, 512x16x56x56x144, has
    3.7e9); held against the plain version chunk by chunk."""
    c = 144
    rows = 2 ** 31 // c + 1000
    x, stats, r = _bn_operands(cuda, (rows, c), torch.bfloat16, True)
    assert x.numel() > 2 ** 31
    got = bn_apply_relu_cuda(x, *stats, r, True)
    torch.cuda.synchronize()
    chunk = 2 ** 20
    for s in range(0, rows, chunk):
        e = min(s + chunk, rows)
        want = bn_apply_relu_plain(x[s:e], *stats, r[s:e], True)
        assert bf16_ulps(got[s:e], want) <= 1.0, s


BWD_NAMES = ("dx", "d_scale", "d_bias", "d_mean", "d_var", "d_res")


def _check_bwd(got, want, ref64, dtype):
    """dx and d_res against the plain version (float32 within 2e-6, bf16
    within 1 ulp); the four per-channel results, whose sums take another
    order than PyTorch's, within rtol 1e-4 (and 1e-4 of the largest entry)
    of the same formulas summed in float64."""
    for name, g, w in zip(BWD_NAMES, got, want):
        if w is None:
            assert g is None, name
        elif name in ("dx", "d_res"):
            assert g.dtype == dtype and g.shape == w.shape, name
            if dtype == torch.float32:
                torch.testing.assert_close(g, w, atol=2e-6, rtol=0, msg=name)
            else:
                assert bf16_ulps(g, w) <= 1.0, name
    for name, g, r in zip(BWD_NAMES[1:5], got[1:5], ref64):
        torch.testing.assert_close(
            g.double(), r, rtol=1e-4, atol=1e-4 * float(r.abs().max()),
            msg=name)


def _bwd_ref64(x, y, dy, scale, mean, var, relu, eps=1e-5):
    sinv = torch.rsqrt(var.double() + eps)
    a = scale.double() * sinv
    g = dy.double()
    if relu:
        g = g * (y.double() > 0)
    xh = x.double() * sinv - mean.double() * sinv
    dims = tuple(range(x.dim() - 1))
    s1, s2 = g.sum(dims), (g * xh).sum(dims)
    return s2, s1, -a * s1, -0.5 * scale.double() * sinv * sinv * s2


@pytest.mark.parametrize("c", [45, 230, 921])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_res", [False, True])
@pytest.mark.parametrize("relu", [True, False])
def test_k2_backward_matches_plain(cuda, c, dtype, with_res, relu):
    shape = (4, 3, 9, 11, c)
    x, stats, r = _bn_operands(cuda, shape, dtype, with_res)
    scale, bias, mean, var = stats
    y = bn_apply_relu_cuda(x, *stats, r, relu)
    dy = torch.randn(shape, device=cuda,
                     generator=torch.Generator(cuda).manual_seed(5)).to(dtype)
    want = bn_apply_relu_bwd_plain(x, y, dy, scale, mean, var, relu, with_res)
    before = bn_apply_relu_bwd_cuda.launches
    got = bn_apply_relu_bwd_cuda(x, y, dy, scale, mean, var, relu, with_res)
    again = bn_apply_relu_bwd_cuda(x, y, dy, scale, mean, var, relu, with_res)
    torch.cuda.synchronize()
    assert bn_apply_relu_bwd_cuda.launches == before + 2
    _check_bwd(got, want, _bwd_ref64(x, y, dy, scale, mean, var, relu), dtype)
    for name, a, b in zip(BWD_NAMES, got, again):  # bit-reproducible
        assert (a is None and b is None) or torch.equal(a, b), name


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("which", ["x", "y", "dy"])
def test_k2_backward_takes_a_misaligned_view(cuda, dtype, which):
    """One of x, y, dy as a contiguous view one element into a buffer (not
    16-byte aligned): the wrapper takes the one-element-a-thread path (its
    plan says so) and the results are those of the aligned call, bit for
    bit in dx and d_res, within the sums' bar in the per-channel ones."""
    shape = (4, 3, 9, 11, 230)
    x, stats, r = _bn_operands(cuda, shape, dtype, True)
    scale, bias, mean, var = stats
    y = bn_apply_relu_cuda(x, *stats, r, True)
    dy = torch.randn(shape, device=cuda,
                     generator=torch.Generator(cuda).manual_seed(6)).to(dtype)
    want = bn_apply_relu_bwd_cuda(x, y, dy, scale, mean, var, True, True)
    ops = {"x": x, "y": y, "dy": dy}
    buf = torch.empty(x.numel() + 8, dtype=dtype, device=cuda)
    view = buf[1:1 + x.numel()].view(shape)
    view.copy_(ops[which])
    assert view.data_ptr() % 16 != 0 and view.is_contiguous()
    ops[which] = view
    assert bwd_plan(x.numel(), 230, x.element_size(), False)["path"] == (
        "scalar")
    got = bn_apply_relu_bwd_cuda(ops["x"], ops["y"], ops["dy"], scale, mean,
                                 var, True, True)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[5], want[5])
    _check_bwd(got, want, _bwd_ref64(x, y, dy, scale, mean, var, True), dtype)


def test_k2_backward_constants_equal_torch_rsqrt_bit_for_bit(cuda):
    """The kernels compute sinv = rsqrt(var + eps), a = scale * sinv and
    mean * sinv themselves. With dy = 1 and no ReLU, dx is `a` and d_bias the
    row count (exact), so d_mean = -a * rows and d_var's factor show the
    kernels' constants: all equal PyTorch's float32 values bit for bit."""
    c, rows = 921, 64
    g = torch.Generator(cuda).manual_seed(7)
    scale = torch.rand(c, device=cuda, generator=g) * 1.5 + 0.5
    mean = torch.randn(c, device=cuda, generator=g)
    var = torch.rand(c, device=cuda, generator=g) * 2.7 + 1e-3
    x = mean.expand(rows, c).contiguous()  # x_hat = x * sinv - mean * sinv
    dy = torch.ones((rows, c), device=cuda)
    for eps in (1e-5, 1e-3):
        dx, d_scale, d_bias, d_mean, d_var, _ = bn_apply_relu_bwd_cuda(
            x, None, dy, scale, mean, var, False, False, eps)
        torch.cuda.synchronize()
        sinv = torch.rsqrt(var + eps)
        a = scale * sinv
        assert torch.equal(dx, a.expand(rows, c))
        assert torch.equal(d_bias, torch.full_like(d_bias, rows))
        assert torch.equal(d_mean, -a * d_bias)
        # S2 = rows * (mean * sinv - mean * sinv): exactly zero only if the
        # kernel's two products are the plain version's
        assert torch.equal(d_scale, torch.zeros_like(d_scale))
        want = bn_apply_relu_bwd_plain(x, None, dy, scale, mean, var, False,
                                       False, eps)
        for got_k, want_k in zip((dx, d_scale, d_bias, d_mean, d_var),
                                 want):
            assert torch.equal(got_k, want_k)


@pytest.mark.parametrize("seed", range(12))
def test_k2_backward_at_random_shapes(cuda, seed):
    """(rows, C) drawn from a seed, down to one row and one channel, where
    the folded view is wider than the tensor and the last folded row is
    ragged: every variant against the plain version and the float64 sums."""
    rng = np.random.default_rng(200 + seed)
    c = int(rng.choice([1, 2, 3, 8, 45, 64, 100, 230, 513, 921, 1200]))
    rows = int(rng.choice([1, 2, 7, 63, 500, 4097]))
    dtype = (torch.float32, torch.bfloat16)[seed % 2]
    relu, with_res = bool(rng.integers(0, 2)), bool(rng.integers(0, 2))
    x, stats, r = _bn_operands(cuda, (rows, c), dtype, with_res, seed=seed)
    scale, bias, mean, var = stats
    y = bn_apply_relu_cuda(x, *stats, r, relu)
    dy = torch.randn((rows, c), device=cuda,
                     generator=torch.Generator(cuda).manual_seed(seed)
                     ).to(dtype)
    got = bn_apply_relu_bwd_cuda(x, y, dy, scale, mean, var, relu, with_res)
    again = bn_apply_relu_bwd_cuda(x, y, dy, scale, mean, var, relu, with_res)
    torch.cuda.synchronize()
    want = bn_apply_relu_bwd_plain(x, y, dy, scale, mean, var, relu, with_res)
    _check_bwd(got, want, _bwd_ref64(x, y, dy, scale, mean, var, relu), dtype)
    for name, a, b in zip(BWD_NAMES, got, again):
        assert (a is None and b is None) or torch.equal(a, b), name


def test_k2_backward_through_autograd_and_strided_dy(cuda):
    """bn_apply_relu on CUDA tensors differentiates through the kernel, and
    a dy that arrives non-contiguous is copied, not refused."""
    shape = (2, 3, 5, 7, 45)
    x, stats, r = _bn_operands(cuda, shape, torch.float32, True)
    leaves = [t.requires_grad_() for t in (x, *stats, r)]
    w = torch.randn((2, 45, 3, 5, 7), device=cuda).permute(0, 2, 3, 4, 1)
    assert not w.is_contiguous()
    launches = bn_apply_relu_bwd_cuda.launches
    copies = bn_apply_relu_bwd_cuda.dy_copies
    y = bn_apply_relu(x, *stats, r, True)
    got = torch.autograd.grad((y * w).sum(), leaves)
    assert bn_apply_relu_bwd_cuda.launches == launches + 1
    assert bn_apply_relu_bwd_cuda.dy_copies == copies + 1
    y2 = bn_apply_relu_plain(x, *stats, r, True)
    want = torch.autograd.grad((y2 * w).sum(), leaves)
    for g, v in zip(got, want):
        torch.testing.assert_close(g, v, rtol=1e-4, atol=1e-4)


def test_k2_backward_finite_differences(cuda):
    """The Function's gradients against central finite differences of its
    own float32 forward on a tiny shape (no ReLU, so the function is
    smooth): a float32 gradcheck, eps 1e-2, within 2e-3."""
    g = torch.Generator(cuda).manual_seed(2)
    shape = (2, 3, 4)
    x = torch.randn(shape, device=cuda, generator=g)
    r = torch.randn(shape, device=cuda, generator=g)
    stats = [torch.rand(4, device=cuda, generator=g) + 0.5,
             torch.randn(4, device=cuda, generator=g),
             torch.randn(4, device=cuda, generator=g),
             torch.rand(4, device=cuda, generator=g) + 1.0]
    w = torch.randn(shape, device=cuda, generator=g)
    args = [x, *stats, r]

    def f(*a):
        return float((bn_apply_relu(a[0], *a[1:5], a[5], False).double()
                      * w.double()).sum())

    leaves = [t.clone().requires_grad_() for t in args]
    got = torch.autograd.grad(
        (bn_apply_relu(leaves[0], *leaves[1:5], leaves[5], False) * w).sum(),
        leaves)
    eps = 1e-2
    for k, (t, gk) in enumerate(zip(args, got)):
        flat = t.reshape(-1)
        for i in range(flat.numel()):
            hi = [a.clone() for a in args]
            lo = [a.clone() for a in args]
            hi[k].reshape(-1)[i] += eps
            lo[k].reshape(-1)[i] -= eps
            fd = (f(*hi) - f(*lo)) / (2 * eps)
            assert abs(fd - float(gk.reshape(-1)[i])) <= 2e-3 * max(
                1.0, abs(fd)), (k, i, fd, float(gk.reshape(-1)[i]))


def test_k2_backward_index_past_2_pow_31(cuda):
    """A backward of more than 2^31 elements takes the 64-bit index path;
    dx and d_res are held against the plain version chunk by chunk and the
    sums against the chunks' float64 sums."""
    c = 144
    rows = 2 ** 31 // c + 1000
    x, stats, r = _bn_operands(cuda, (rows, c), torch.bfloat16, True)
    scale, bias, mean, var = stats
    y = bn_apply_relu_cuda(x, *stats, r, True)
    del r
    dy = torch.randn((rows, c), device=cuda, dtype=torch.bfloat16,
                     generator=torch.Generator(cuda).manual_seed(3))
    got = bn_apply_relu_bwd_cuda(x, y, dy, scale, mean, var, True, True)
    torch.cuda.synchronize()
    chunk = 2 ** 20
    ref = [torch.zeros(c, device=cuda, dtype=torch.float64) for _ in range(4)]
    for s in range(0, rows, chunk):
        e = min(s + chunk, rows)
        want = bn_apply_relu_bwd_plain(x[s:e], y[s:e], dy[s:e], scale, mean,
                                       var, True, True)
        assert bf16_ulps(got[0][s:e], want[0]) <= 1.0, s
        assert bf16_ulps(got[5][s:e], want[5]) <= 1.0, s
        for acc, part in zip(ref, _bwd_ref64(x[s:e], y[s:e], dy[s:e], scale,
                                             mean, var, True)):
            acc += part
    for name, g, v in zip(BWD_NAMES[1:5], got[1:5], ref):
        torch.testing.assert_close(g.double(), v, rtol=1e-4,
                                   atol=1e-4 * float(v.abs().max()), msg=name)


def test_train_step_on_the_card_matches_the_cpu(cuda):
    """Two float32 train steps of the full-width model on a small clip, on
    the card (kernels) and on the CPU (plain versions), from the same seeds:
    loss within rtol 1e-4, parameters within atol 2e-5 from a seeded
    non-zero Adam state (torch_helpers.seed_adam says why not from zero)."""
    from zeroshotvideoclassification_tpu_torch.config import Config
    from zeroshotvideoclassification_tpu_torch.models import get_network
    from zeroshotvideoclassification_tpu_torch.models.layers import (
        init_weights,
    )
    from zeroshotvideoclassification_tpu_torch.train import (
        make_optimizer,
        make_train_step,
    )

    rng = np.random.default_rng(0)
    x = rng.uniform(-0.5, 0, (4, 1, 8, 32, 32, 3)).astype(np.float32)
    ce = rng.normal(size=(5, 300)).astype(np.float32)
    ce /= np.linalg.norm(ce, axis=1, keepdims=True)
    labels = rng.integers(0, 5, 4).astype(np.int32)
    runs = {}
    for dev in ("cpu", cuda):
        m = get_network(Config(network="r2plus1d_18"))
        init_weights(m, torch.Generator().manual_seed(0))
        m = m.to(device=dev, memory_format=torch.channels_last_3d)
        opt = seed_adam(make_optimizer(m.parameters(), 1e-3), m, seed=1)
        step = make_train_step(m, opt, compute_dtype=torch.float32)
        t = [torch.from_numpy(a).to(dev) for a in
             (x, ce[labels], labels, np.ones(4, np.float32), ce)]
        before = (bn_apply_relu_cuda.launches,
                  bn_apply_relu_bwd_cuda.launches)
        losses = [float(step(*t)["loss"]) for _ in range(2)]
        after = (bn_apply_relu_cuda.launches, bn_apply_relu_bwd_cuda.launches)
        runs[str(dev)] = (losses, {k: v.cpu() for k, v in
                                   m.state_dict().items()},
                          [a - b for a, b in zip(after, before)])
    (l0, sd0, n0), (l1, sd1, n1) = runs.values()
    assert n0 == [0, 0] and n1 == [74, 74]  # 37 epilogues x 2 steps
    np.testing.assert_allclose(l1, l0, rtol=1e-4)
    for k in sd0:
        if sd0[k].dtype == torch.float32:
            # BN running statistics of the late layers span 16 positions at
            # this size: held at the train-forward bar, not the update's
            tol = 1e-4 if "running" in k else 2e-5
            torch.testing.assert_close(sd1[k], sd0[k], atol=tol, rtol=1e-4,
                                       msg=k)


def test_model_forward_runs_through_the_kernels(cuda):
    """The full-depth r2plus1d_18 at a small input, in bf16 on the card,
    launches K2 at each of its 37 epilogues and tracks the CPU f32
    forward. Both share seeded per-channel BN statistics
    (torch_helpers.calibrate_bn)."""
    from zeroshotvideoclassification_tpu_torch.cli.infer import load_model
    from zeroshotvideoclassification_tpu_torch.config import Config
    from zeroshotvideoclassification_tpu_torch.train import eval_step

    cfg32 = Config(network="r2plus1d_18", compute_dtype="float32")
    cfg16 = Config(network="r2plus1d_18", compute_dtype="bfloat16")
    x = torch.from_numpy(np.stack([np.stack(
        [synthetic_clip(k, 8, 64, 64)] * 2) for k in range(2)]))
    x = (x.float() / 255.0 - 1.0) / 2.0
    m_cpu = calibrate_bn(load_model(cfg32, None, "cpu")[0], x, 1)
    m16 = copy_bn(m_cpu, load_model(cfg16, None, cuda)[0])
    want = eval_step(m_cpu, x)
    before = bn_apply_relu_cuda.launches
    got = eval_step(m16, x.to(cuda, torch.bfloat16)).cpu()
    assert bn_apply_relu_cuda.launches - before == 37
    cos = torch.nn.functional.cosine_similarity(got, want, dim=1)
    assert float(cos.min()) > 0.999, cos


def test_engine_on_the_card(cuda, tmp_path):
    from zeroshotvideoclassification_tpu_torch.serve import InferenceEngine

    paths = []
    for k in range(3):
        p = tmp_path / f"v{k}.npy"
        np.save(p, synthetic_clip(k, 12, 64, 86))
        paths.append(str(p))
    embed = np.random.default_rng(0).normal(size=(4, 300)).astype(np.float32)
    engine = InferenceEngine(["a", "b", "c", "d"], embed, n_clips=2,
                             clip_len=4, size=32, max_batch=4, device=cuda)
    try:
        k1 = fused_video_transform_cuda.launches
        k2 = bn_apply_relu_cuda.launches
        res = engine.classify(paths)
        assert [r["video"] for r in res] == paths
        assert all(r["top_class"] in "abcd" for r in res)
        # `cuda` is every visible GPU: one K1 and 37 K2 a replica
        n = engine.n_shards
        assert n == torch.cuda.device_count()
        assert fused_video_transform_cuda.launches == k1 + n
        assert bn_apply_relu_cuda.launches == k2 + 37 * n
    finally:
        engine.close()


def test_engine_over_two_replicas_on_one_card(cuda, tmp_path):
    """Two replicas on cuda:0 (two device threads, one model): float32
    embeddings within 1e-5 of one replica's, one K1 and 37 K2 a replica
    and dispatch, and the bucket rounded up to tile the replicas."""
    from zeroshotvideoclassification_tpu_torch.serve import InferenceEngine

    paths = []
    for k in range(3):
        p = tmp_path / f"v{k}.npy"
        np.save(p, synthetic_clip(k, 12, 64, 86))
        paths.append(str(p))
    embed = np.random.default_rng(0).normal(size=(4, 300)).astype(np.float32)
    kw = dict(n_clips=2, clip_len=4, size=32, max_batch=5,
              compute_dtype="float32")
    one = InferenceEngine(["a", "b", "c", "d"], embed, device="cuda:0", **kw)
    two = InferenceEngine(["a", "b", "c", "d"], embed,
                          device=["cuda:0", "cuda:0"], **kw)
    try:
        assert two.batch_buckets == [6] and two.stats()["data_shards"] == 2
        want, _ = one.embed_paths(paths)
        k1 = fused_video_transform_cuda.launches
        k2 = bn_apply_relu_cuda.launches
        got, ok = two.embed_paths(paths)
        assert fused_video_transform_cuda.launches == k1 + 2
        assert bn_apply_relu_cuda.launches == k2 + 74
        assert ok.all()
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    finally:
        one.close()
        two.close()


@pytest.mark.parametrize("head", ["mlp", "linear"])
def test_graph_replays_match_eager_steps(cuda, head):
    """make_scan_train_step(steps=2) on the card: two groups and a tail of
    one (the first group eager, then the capture; the second group one
    replay of the two-step graph, the tail one of the one-step graph)
    against five eager steps of make_train_step from the same state, float32,
    r2plus1d_18 on 4 clips of 8x32x32: losses rtol 1e-4, parameters atol
    2e-5, Adam's count and the step count equal. A replay calls no
    wrapper (the launch counters count the capture, not the replays), a
    replaced optimizer tensor or another generator raises, and under the
    linear head (dropout 0.05) two replays of one batch draw other masks."""
    from zeroshotvideoclassification_tpu_torch.config import Config
    from zeroshotvideoclassification_tpu_torch.models import get_network
    from zeroshotvideoclassification_tpu_torch.models.layers import (
        init_weights,
    )
    from zeroshotvideoclassification_tpu_torch.train import (
        make_optimizer,
        make_scan_train_step,
        make_train_step,
    )

    rng = np.random.default_rng(0)
    ce = rng.normal(size=(5, 300)).astype(np.float32)
    ce /= np.linalg.norm(ce, axis=1, keepdims=True)
    data = []
    for _ in range(5):
        labels = rng.integers(0, 5, 4).astype(np.int32)
        x = rng.uniform(-0.5, 0, (4, 1, 8, 32, 32, 3)).astype(np.float32)
        data.append([torch.from_numpy(a).to(cuda) for a in
                     (x, ce[labels], labels, np.ones(4, np.float32))])
    ce_t = torch.from_numpy(ce).to(cuda)
    runs = {}
    for grouped in (True, False):
        m = get_network(Config(network="r2plus1d_18", head=head))
        init_weights(m, torch.Generator().manual_seed(0))
        m = m.to(device=cuda, memory_format=torch.channels_last_3d)
        opt = seed_adam(make_optimizer(m.parameters(), 1e-3), m, seed=1)
        gen = torch.Generator(cuda).manual_seed(5)
        if grouped:
            scan = make_scan_train_step(m, opt, torch.float32, 2)
            losses = []
            for start, n in ((0, 2), (2, 2), (4, 1)):
                for k in range(n):
                    scan.stage(k, *data[start + k])
                if start == 2:
                    before = (bn_apply_relu_cuda.launches,
                              bn_apply_relu_bwd_cuda.launches)
                losses += scan.run(n, ce_t, gen)["loss"].tolist()
            assert (bn_apply_relu_cuda.launches,
                    bn_apply_relu_bwd_cuda.launches) == before
            state, scan_opt, scan_gen = scan.state, opt, gen
        else:
            step = make_train_step(m, opt, torch.float32)
            losses = [float(step(*b, ce_t, gen)["loss"]) for b in data]
            state = step.state
        runs[grouped] = (losses, {k: v.detach().clone() for k, v in
                                  m.named_parameters()},
                         int(opt.count), state.step)
    (lg, pg, cg, sg), (le, pe, ce_, se) = runs[True], runs[False]
    assert cg == ce_ == 1005 and sg == se == 5
    # under dropout the replays draw the eager steps' masks: one generator,
    # advanced by each replay as far as the eager steps advance it
    np.testing.assert_allclose(lg, le, rtol=1e-4)
    for k in pe:
        torch.testing.assert_close(pg[k], pe[k], atol=2e-5, rtol=0, msg=k)
    if head == "linear":
        for k in range(2):
            scan.stage(k, *data[0])
        a = scan.run(2, ce_t, scan_gen)["loss"]
        b = scan.run(2, ce_t, scan_gen)["loss"]
        assert not torch.equal(a, b)
        with pytest.raises(ValueError, match="another generator"):
            scan.run(2, ce_t, torch.Generator(cuda))
        p0 = next(iter(scan_opt.state))
        scan_opt.state[p0]["exp_avg"] = scan_opt.state[p0]["exp_avg"].clone()
        with pytest.raises(RuntimeError, match="replaced"):
            scan.run(2, ce_t, scan_gen)


def test_capture_under_ballast_completes_or_raises_oom(cuda):
    """F4: a ballast tensor leaves half of the eager step's working set
    free, then three times it, before make_scan_train_step(steps=2) runs a
    group eagerly, captures it and replays it (r2plus1d_18, float32, 4
    clips of 8x32x32, after one eager step that fills cuDNN's plan cache and
    the allocator's cache). Each run completes, its losses within rtol 1e-4
    of the same eager steps, or raises torch.OutOfMemoryError; no other
    error comes out of the capture."""
    from zeroshotvideoclassification_tpu_torch.config import Config
    from zeroshotvideoclassification_tpu_torch.models import get_network
    from zeroshotvideoclassification_tpu_torch.models.layers import (
        init_weights,
    )
    from zeroshotvideoclassification_tpu_torch.train import (
        make_optimizer,
        make_scan_train_step,
        make_train_step,
    )

    rng = np.random.default_rng(0)
    ce = rng.normal(size=(5, 300)).astype(np.float32)
    ce /= np.linalg.norm(ce, axis=1, keepdims=True)
    labels = rng.integers(0, 5, 4).astype(np.int32)
    x = rng.uniform(-0.5, 0, (4, 1, 8, 32, 32, 3)).astype(np.float32)
    batch = [torch.from_numpy(a).to(cuda) for a in
             (x, ce[labels], labels, np.ones(4, np.float32))]
    ce_t = torch.from_numpy(ce).to(cuda)

    def model():
        m = get_network(Config(network="r2plus1d_18"))
        init_weights(m, torch.Generator().manual_seed(0))
        m = m.to(device=cuda, memory_format=torch.channels_last_3d)
        return m, seed_adam(make_optimizer(m.parameters(), 1e-3), m, seed=1)

    m, opt = model()
    step = make_train_step(m, opt, torch.float32)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    want = [float(step(*batch, ce_t)["loss"]) for _ in range(5)]
    work = torch.cuda.max_memory_allocated() - base
    del m, opt, step
    outcomes = []
    for level in (work // 2, 3 * work):
        m, opt = model()
        scan = make_scan_train_step(m, opt, torch.float32, 2)
        scan.single(*batch, ce_t)
        for k in range(2):
            scan.stage(k, *batch)
        torch.cuda.synchronize()
        free = torch.cuda.mem_get_info()[0]
        ballast = torch.empty(max(free - level, 0) // 2 ** 21 * 2 ** 21,
                              dtype=torch.uint8, device=cuda)
        try:
            got = [v for _ in range(2)
                   for v in scan.run(2, ce_t)["loss"].tolist()]
            np.testing.assert_allclose(got, want[1:], rtol=1e-4)
            outcomes.append("completed")
        except torch.OutOfMemoryError:
            outcomes.append("OutOfMemoryError")
        del ballast, scan, m, opt
        gc.collect()
        torch.cuda.empty_cache()
    assert len(outcomes) == 2
