"""The SUN still-image transforms of the port against the JAX package's, on
the CPU from numpy seeds: the 2-tap image-motion transform (K4's plain
version) against the XLA gather and against the Pallas kernel in interpret
mode (as tests/test_resample_pallas.py runs it), the antialiased transform
in both implementations, the wrappers' dispatch and validation, and a
HostPipeline batch of seeded image files through both device_batch
functions. The CUDA kernel itself is compared with the plain version on the
card, in tests/test_torch_cuda.py."""

import jax
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import jax.numpy as jnp
import zeroshotvideoclassification_tpu.ops.resample_pallas as rp
from zeroshotvideoclassification_tpu.config import Config as JaxConfig
from zeroshotvideoclassification_tpu.data.datasets import (
    VideoTable as JaxVideoTable,
)
from zeroshotvideoclassification_tpu.data.pipeline import (
    HostPipeline as JaxHostPipeline,
    device_batch as jax_device_batch,
)
from zeroshotvideoclassification_tpu.data.stillimages import (
    CH_OFFSET,
    CH_SCALE,
    camera_motion_trajectory,
    motion_resample_indices,
)
from zeroshotvideoclassification_tpu.ops.resample import (
    fused_image_motion_transform as jax_motion,
    fused_image_motion_transform_aa as jax_motion_aa,
)
from zeroshotvideoclassification_tpu_torch.config import Config
from zeroshotvideoclassification_tpu_torch.data import stillimages as port_still
from zeroshotvideoclassification_tpu_torch.data.datasets import VideoTable
from zeroshotvideoclassification_tpu_torch.data.pipeline import (
    HostPipeline,
    device_batch,
)
from zeroshotvideoclassification_tpu_torch.ops.resample import (
    fused_image_motion_transform,
    fused_image_motion_transform_aa,
)
from zeroshotvideoclassification_tpu_torch.ops.resample_cuda import (
    fused_image_motion_transform_cuda,
    image_motion_transform,
)
from torch_helpers import bf16_ulps

S = 112


@pytest.fixture
def interpret_pallas(monkeypatch):
    orig = pl.pallas_call

    def patched(*args, **kw):
        kw["interpret"] = True
        return orig(*args, **kw)

    monkeypatch.setattr(rp.pl, "pallas_call", patched)


def _tensors(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _motion_case(rng, b=2, t=4, hw=(180, 220), trajectories=None):
    """images uint8 [b, *hw, 3] and the six stacked tap arrays [b, t, S]."""
    imgs = rng.integers(0, 256, (b, *hw, 3), dtype=np.uint8)
    idx = []
    for k in range(b):
        traj = (camera_motion_trajectory(hw, S, t, rng)
                if trajectories is None else np.asarray(trajectories[k]))
        idx.append(motion_resample_indices(traj, hw, S))
    return imgs, [np.stack([idx[k][j] for k in range(b)]) for j in range(6)]


# ------------------------------------------------ K4's plain version --------

def test_motion_transform_matches_jax_gather_f32(rng):
    """float32 within 1e-5 of the XLA gather version (the bar the JAX
    package holds its Pallas kernel to, tests/test_resample_pallas.py:75);
    the two run the same float32 operations in the same order."""
    imgs, taps = _motion_case(rng)
    want = np.asarray(jax_motion(imgs, *taps, jnp.asarray(CH_SCALE),
                                 jnp.asarray(CH_OFFSET)))
    got = fused_image_motion_transform(*_tensors(imgs, *taps), CH_SCALE,
                                       CH_OFFSET)
    assert got.shape == (2, 4, S, S, 3) and got.dtype == torch.float32
    assert got.is_contiguous()
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


def test_motion_transform_matches_pallas_interpret(interpret_pallas, rng):
    """Within 1e-5 of the TPU kernel K4 replaces, run in interpret mode."""
    imgs, taps = _motion_case(rng)
    want = np.asarray(rp.fused_image_motion_transform_pallas(
        imgs, *taps, ch_scale=tuple(map(float, CH_SCALE)),
        ch_offset=tuple(map(float, CH_OFFSET))))
    got = fused_image_motion_transform(*_tensors(imgs, *taps), CH_SCALE,
                                       CH_OFFSET)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


def test_motion_transform_bf16_is_the_rounded_f32(rng):
    """bf16 output within 1 bf16 ulp of the JAX float32 result rounded to
    bf16 (one rounding at the end on both sides)."""
    imgs, taps = _motion_case(rng, b=1, t=2)
    want = np.asarray(jax_motion(imgs, *taps, jnp.asarray(CH_SCALE),
                                 jnp.asarray(CH_OFFSET)))
    got = fused_image_motion_transform(*_tensors(imgs, *taps), CH_SCALE,
                                       CH_OFFSET, out_dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16
    assert bf16_ulps(got, torch.from_numpy(want).to(torch.bfloat16)) <= 1.0


def test_motion_transform_overhanging_boxes_match_jax(rng):
    """Boxes past the image border (min side in [87, 111] stays unscaled, so
    side-112 boxes overhang) are clamped per axis and stretched; the taps
    come from the host, so both sides must read them alike: atol 1e-5."""
    traj = [[[0, 5, 112], [0, 200, 112], [0, 300, 112]]]
    imgs, taps = _motion_case(rng, b=1, t=3, hw=(100, 400), trajectories=traj)
    want = np.asarray(jax_motion(imgs, *taps, jnp.asarray(CH_SCALE),
                                 jnp.asarray(CH_OFFSET)))
    got = fused_image_motion_transform(*_tensors(imgs, *taps), CH_SCALE,
                                       CH_OFFSET)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


def test_port_host_functions_are_the_jax_package_s(rng):
    """The port's copy of the still-image host side gives the same
    trajectory, taps and constants from the same seed."""
    a = camera_motion_trajectory((200, 300), S, 8, np.random.default_rng(3))
    b = port_still.camera_motion_trajectory((200, 300), S, 8,
                                            np.random.default_rng(3))
    np.testing.assert_array_equal(a, b)
    for x, y in zip(motion_resample_indices(a, (200, 300), S),
                    port_still.motion_resample_indices(b, (200, 300), S)):
        assert x.dtype == y.dtype and x.tobytes() == y.tobytes()
    assert port_still.CH_SCALE.tobytes() == CH_SCALE.tobytes()
    assert port_still.CH_OFFSET.tobytes() == CH_OFFSET.tobytes()


def test_image_motion_wrapper_dispatch_and_validation(rng):
    imgs, taps = _motion_case(rng, b=1, t=2)
    args = _tensors(imgs, *taps)
    want = fused_image_motion_transform(*args, CH_SCALE, CH_OFFSET)
    # a CPU tensor takes the plain version, and only because it is on the CPU
    assert torch.equal(image_motion_transform(*args, CH_SCALE, CH_OFFSET),
                       want)
    # scale and offset may be tensors or sequences
    assert torch.equal(fused_image_motion_transform(
        *args, torch.from_numpy(CH_SCALE), list(map(float, CH_OFFSET))), want)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        fused_image_motion_transform_cuda(*args, CH_SCALE, CH_OFFSET)
    with pytest.raises(ValueError, match="no transform for device"):
        image_motion_transform(*[a.to("meta") for a in args], CH_SCALE,
                               CH_OFFSET)
    with pytest.raises(ValueError, match="uint8"):
        fused_image_motion_transform(args[0].float(), *args[1:], CH_SCALE,
                                     CH_OFFSET)
    with pytest.raises(ValueError, match="y1 must be"):
        fused_image_motion_transform(args[0], args[1], args[2][:, :1],
                                     *args[3:], CH_SCALE, CH_OFFSET)
    with pytest.raises(ValueError, match="3 floats"):
        fused_image_motion_transform(*args, CH_SCALE[:2], CH_OFFSET)
    with pytest.raises(ValueError, match="out_dtype"):
        fused_image_motion_transform(*args, CH_SCALE, CH_OFFSET,
                                     out_dtype=torch.float16)
    with pytest.raises(ValueError, match="contiguous"):
        fused_image_motion_transform_cuda(
            args[0].transpose(1, 2).contiguous().transpose(1, 2), *args[1:],
            CH_SCALE, CH_OFFSET)


# ------------------------------------------------ antialiased transform -----

# The JAX function is held op by op (jax.disable_jit) at atol 5e-5: the same
# float32 weights, the products in another summation order. Compiled, XLA's
# CPU fusion rounds the weights' arithmetic differently (extent / 112 becomes
# a product with the reciprocal, (d + 0.5) * scale + o is contracted), which
# moves a filter centre near 300 px by one float32 ulp (3e-5 px), a triangle
# weight by ~1e-5 and an output by up to 2e-4 after the mean/std scaling;
# the JAX package's own two implementations differ by as much under jit. So
# the compiled function is held at 5e-4, still 4x under its own bar against
# torch's antialias=True (2e-3, tests/test_stillimages.py:132).
AA_ATOL, AA_ATOL_JIT = 5e-5, 5e-4


def _aa_both(imgs, traj, hw, impl, **kw):
    """-> (the port's result, the JAX function's op by op, and compiled)."""
    traj = np.asarray(traj, np.int32)
    hw = np.asarray(hw, np.int32)
    jitted = np.asarray(jax_motion_aa(imgs, traj, hw, CH_SCALE, CH_OFFSET,
                                      impl=impl, **kw))
    with jax.disable_jit():
        eager = np.asarray(jax_motion_aa(
            jnp.asarray(imgs), jnp.asarray(traj), jnp.asarray(hw),
            jnp.asarray(CH_SCALE), jnp.asarray(CH_OFFSET), impl=impl, **kw))
    got = fused_image_motion_transform_aa(
        *_tensors(imgs, traj, hw), CH_SCALE, CH_OFFSET, impl=impl, **kw)
    return got, eager, jitted


@pytest.mark.parametrize("impl", ["mxu", "gather"])
def test_aa_transform_matches_jax(rng, impl):
    hw = (300, 340)
    imgs = rng.integers(0, 256, (2, 320, 342, 3), dtype=np.uint8)
    imgs[:, hw[0]:] = 0
    imgs[:, :, hw[1]:] = 0
    traj = [camera_motion_trajectory(hw, S, 3, rng) for _ in range(2)]
    got, want, jitted = _aa_both(imgs, traj, [hw, hw], impl)
    assert got.shape == (2, 3, S, S, 3) and got.is_contiguous()
    np.testing.assert_allclose(got.numpy(), want, atol=AA_ATOL)
    np.testing.assert_allclose(got.numpy(), jitted, atol=AA_ATOL_JIT)


@pytest.mark.parametrize("impl", ["mxu", "gather"])
def test_aa_transform_overhang_and_upscale_match_jax(rng, impl):
    """The clamp-and-stretch of overhanging boxes and the upscaling crop
    (plain bilinear, as PIL does for scale < 1)."""
    hw = (100, 400)
    imgs = rng.integers(0, 256, (1, *hw, 3), dtype=np.uint8)
    traj = [[[0, 5, 112], [0, 340, 112], [0, 10, 250], [3, 7, 90]]]
    got, want, jitted = _aa_both(imgs, traj, [hw], impl)
    np.testing.assert_allclose(got.numpy(), want, atol=AA_ATOL)
    np.testing.assert_allclose(got.numpy(), jitted, atol=AA_ATOL_JIT)


@pytest.mark.parametrize("impl", ["mxu", "gather"])
def test_aa_transform_matches_torch_antialias(rng, impl):
    """Against the oracle itself (F.interpolate antialias=True on the crop),
    at the JAX package's bar of tests/test_stillimages.py: atol 2e-3 after
    the mean/std normalisation."""
    import torch.nn.functional as F

    hw = (384, 460)
    img = rng.integers(0, 256, (*hw, 3), dtype=np.uint8)
    traj = camera_motion_trajectory(hw, S, 4, rng)
    got = fused_image_motion_transform_aa(
        *_tensors(img[None], traj[None].astype(np.int32),
                  np.asarray([hw], np.int32)), CH_SCALE, CH_OFFSET,
        impl=impl)[0].numpy()
    for f, (y, x, side) in enumerate(traj):
        crop = img[y:y + side, x:x + side].astype(np.float32) / 255.0
        t = F.interpolate(torch.from_numpy(crop).permute(2, 0, 1)[None],
                          size=(S, S), mode="bilinear", align_corners=False,
                          antialias=True)[0].permute(1, 2, 0).numpy()
        want = (t - port_still.KINETICS_MEAN) / port_still.KINETICS_STD
        np.testing.assert_allclose(got[f], want, atol=2e-3)


@pytest.mark.parametrize("impl", ["mxu", "gather"])
def test_aa_zero_weight_sample_is_finite_and_matches_jax(impl):
    """A missing image: zero canvas, zero trajectory, img_hw 0. The weights
    divide by max(sum, 1e-20) and stay finite; both sides give the offset."""
    imgs = np.zeros((2, 64, 64, 3), np.uint8)
    traj = np.zeros((2, 4, 3), np.int32)
    got, want, jitted = _aa_both(imgs, traj, [[0, 0], [64, 64]], impl,
                                 crop_size=32)
    assert bool(torch.isfinite(got).all())
    np.testing.assert_allclose(got.numpy(), want, atol=AA_ATOL)
    np.testing.assert_allclose(got.numpy(), jitted, atol=AA_ATOL)


def test_aa_rejects_too_few_taps_and_unknown_impl():
    args = _tensors(np.zeros((1, 512, 512, 3), np.uint8),
                    np.zeros((1, 2, 3), np.int32),
                    np.asarray([[512, 512]], np.int32))
    with pytest.raises(ValueError, match="max_taps"):
        fused_image_motion_transform_aa(*args, CH_SCALE, CH_OFFSET,
                                        crop_size=64, impl="gather")
    out = fused_image_motion_transform_aa(*args, CH_SCALE, CH_OFFSET,
                                          crop_size=64, impl="mxu")
    assert out.shape == (1, 2, 64, 64, 3)
    with pytest.raises(ValueError, match="impl"):
        fused_image_motion_transform_aa(*args, CH_SCALE, CH_OFFSET,
                                        crop_size=64, impl="MXU")
    with pytest.raises(ValueError, match="trajectory must be"):
        fused_image_motion_transform_aa(args[0], args[1].long(), args[2],
                                        CH_SCALE, CH_OFFSET)
    with pytest.raises(ValueError, match="img_hw must be"):
        fused_image_motion_transform_aa(args[0], args[1], args[2][:, :1],
                                        CH_SCALE, CH_OFFSET)


def test_aa_bf16_output_is_the_rounded_f32(rng):
    imgs = rng.integers(0, 256, (1, 130, 150, 3), dtype=np.uint8)
    traj = camera_motion_trajectory((130, 150), S, 2, rng)[None]
    args = _tensors(imgs, traj.astype(np.int32),
                    np.asarray([[130, 150]], np.int32))
    f32 = fused_image_motion_transform_aa(*args, CH_SCALE, CH_OFFSET)
    b16 = fused_image_motion_transform_aa(*args, CH_SCALE, CH_OFFSET,
                                          out_dtype=torch.bfloat16)
    assert b16.dtype == torch.bfloat16 and b16.is_contiguous()
    assert torch.equal(b16, f32.to(torch.bfloat16))


# ------------------------------------------------ pipeline -> device batch --

@pytest.mark.parametrize("aa", [True, False])
def test_sun_pipeline_device_batch_matches_jax(tmp_path, rng, aa):
    """Seeded image files (sizes that pass through, get bounded up, and get
    fitted to the canvas; one missing) through HostPipeline and device_batch
    of both packages: byte-identical host batches, device batches within
    1e-5 (2-tap) or AA_ATOL / AA_ATOL_JIT (antialiased, see above)."""
    import cv2

    paths = []
    for i, hw in enumerate([(200, 260), (120, 150), (300, 620), (230, 240)]):
        img = rng.integers(0, 256, size=(*hw, 3), dtype=np.uint8)
        p = str(tmp_path / f"im{i}.png")
        cv2.imwrite(p, cv2.cvtColor(img, cv2.COLOR_RGB2BGR))
        paths.append(p)
    paths.append(str(tmp_path / "missing.jpg"))  # broken sample
    emb = rng.normal(size=(2, 300)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    kw = dict(name="sun", fnames=np.asarray(paths, object),
              label_idx=np.asarray([0, 1, 0, 1, 0], np.int32),
              classes=["a", "b"], class_embed=emb, loader="image",
              is_validation=False, n_clips=1)
    cfg_kw = dict(dataset="sun2both", clip_len=4, canvas_hw=(256, 342),
                  sun_antialias=aa, prefetch_depth=0, decode_workers=2)
    want_h = next(iter(JaxHostPipeline(JaxVideoTable(**kw),
                                       JaxConfig(**cfg_kw), 5, seed=0)))
    got_h = next(iter(HostPipeline(VideoTable(**kw), Config(**cfg_kw), 5,
                                   seed=0)))
    assert got_h.image_mode and got_h.canvas.shape == (5, 256, 342, 3)
    assert (got_h.trajectory is not None) == aa
    assert got_h.weight.sum() == 4  # the missing image got weight 0
    for f in ("canvas", "y0", "y1", "wy", "x0", "x1", "wx", "z", "label",
              "weight") + (("trajectory", "img_hw") if aa else ()):
        a, b = getattr(got_h, f), getattr(want_h, f)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), f
    want = jax_device_batch(want_h, 1, 4)
    got = device_batch(got_h, 1, 4, torch.float32, "cpu")
    assert tuple(got["x"].shape) == (5, 1, 4, S, S, 3)
    assert bool(torch.isfinite(got["x"]).all())
    np.testing.assert_allclose(got["x"].numpy(), np.asarray(want["x"]),
                               atol=AA_ATOL_JIT if aa else 1e-5)
    if aa:
        with jax.disable_jit():
            eager = np.asarray(jax_device_batch(want_h, 1, 4)["x"])
        np.testing.assert_allclose(got["x"].numpy(), eager, atol=AA_ATOL)
    for k in ("z", "label", "weight"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    # the zero-weight sample is its per-channel offset, as on the JAX side
    x = got["x"].numpy()
    assert x.min() > -3 and x.max() < 3.5
