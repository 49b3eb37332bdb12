"""K3, the (3,1,1) temporal conv op of the port against the JAX package's
Pallas kernel in interpret mode (as tests/test_temporal_conv.py runs it), on
the CPU from numpy seeds: forward, gradients, bf16, the tile plan, the
wrappers' validation, and the weight's way across through models/bridge.
The CUDA kernel itself is compared with the plain version on the card, in
tests/test_torch_cuda.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zeroshotvideoclassification_tpu.ops.temporal_conv import (
    temporal_conv3 as jax_temporal_conv3,
)
from zeroshotvideoclassification_tpu_torch.models import bridge
from zeroshotvideoclassification_tpu_torch.ops.temporal_conv import (
    temporal_conv3,
    temporal_conv3_cuda,
    temporal_conv3_plain,
    tile_plan,
)
from torch_helpers import bf16_ulps


@pytest.fixture(autouse=True)
def grad_enabled():
    """Another test module switches autograd off for its whole process when
    it is imported; the tests here differentiate."""
    with torch.enable_grad():
        yield


def _operands(shape, co, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=shape).astype(np.float32)
    w = (rng.normal(size=(3, 1, 1, shape[-1], co)) * 0.1).astype(np.float32)
    return x, w


# the shapes of tests/test_temporal_conv.py, one with ragged Ci and Co (no
# multiple of the kernel's tiles), and one frame only (both neighbours are
# padding)
@pytest.mark.parametrize("shape,co", [
    ((2, 5, 4, 6, 16), 8), ((1, 4, 4, 4, 8), 8), ((2, 3, 4, 4, 23), 9),
    ((1, 1, 4, 4, 8), 5)])
def test_forward_matches_pallas_interpret(shape, co):
    """float32 within atol/rtol 1e-5 of the TPU kernel (the bar of
    tests/test_temporal_conv.py): the same three products, summed in
    another order."""
    x, w = _operands(shape, co)
    want = np.asarray(jax_temporal_conv3(
        jnp.asarray(x), jnp.asarray(w), compute_dtype=jnp.float32,
        interpret=True))
    got = temporal_conv3(torch.from_numpy(x), torch.from_numpy(w),
                         torch.float32)
    assert got.shape == (*shape[:4], co) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("shape,co", [((1, 4, 4, 4, 8), 8),
                                      ((2, 3, 4, 4, 23), 9)])
def test_gradients_match_pallas_interpret(shape, co):
    """Both gradients within atol/rtol 1e-4 of the JAX op's custom VJP (the
    XLA convolution's), the bar of tests/test_temporal_conv.py."""
    x, w = _operands(shape, co, seed=1)

    def loss(x, w):
        return jnp.sum(jnp.square(jax_temporal_conv3(
            x, w, jnp.float32, interpret=True)))

    want = jax.grad(loss, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    xt = torch.from_numpy(x).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    got = torch.autograd.grad(
        temporal_conv3(xt, wt, torch.float32).square().sum(), (xt, wt))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(got[1].numpy(),
                               np.asarray(want[1]).reshape(w.shape),
                               atol=1e-4, rtol=1e-4)
    # only one of the two asked for
    (gx,) = torch.autograd.grad(
        temporal_conv3(xt, wt.detach(), torch.float32).square().sum(), xt)
    np.testing.assert_allclose(gx.numpy(), got[0].numpy(), atol=1e-6)


def test_bf16_is_the_f32_result_of_rounded_operands():
    """compute_dtype bf16: operands rounded to bf16, float32 accumulation,
    one rounding: within 2 bf16 ulp of the float32 op on the rounded
    operands, and of the JAX op in bf16."""
    x, w = _operands((2, 5, 4, 6, 16), 8, seed=2)
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    got = temporal_conv3(xt, wt, torch.bfloat16)
    assert got.dtype == torch.bfloat16
    want = temporal_conv3(xt.to(torch.bfloat16).float(),
                          wt.to(torch.bfloat16).float(), torch.float32)
    assert bf16_ulps(got, want) <= 2.0
    jax_got = np.asarray(jax_temporal_conv3(
        jnp.asarray(x), jnp.asarray(w), compute_dtype=jnp.bfloat16,
        interpret=True).astype(jnp.float32))
    assert bf16_ulps(got, torch.from_numpy(jax_got)) <= 2.0


def test_plain_version_takes_any_strides():
    """A single-threaded CPU convolution hands over NCDHW memory; the plain
    version (and the op on the CPU) must not care (1e-6: a strided operand
    takes another matrix-product routine, which sums in another order)."""
    x, w = _operands((2, 3, 4, 4, 6), 5, seed=3)
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    strided = xt.permute(0, 4, 1, 2, 3).contiguous().permute(0, 2, 3, 4, 1)
    assert not strided.is_contiguous()
    want = temporal_conv3_plain(xt, wt)
    torch.testing.assert_close(temporal_conv3_plain(strided, wt), want,
                               atol=1e-6, rtol=0)
    torch.testing.assert_close(temporal_conv3(strided, wt, torch.float32),
                               want, atol=1e-6, rtol=0)


# (Ci, Co) of every temporal conv in r2plus1d_18 (the stem, then the blocks'
# midplanes), at the rows a 16-clip batch of 16x112x112 gives each
NETWORK_TCONVS = [(45, 64, 16 * 16 * 56 * 56), (144, 64, 16 * 16 * 56 * 56),
                  (230, 128, 16 * 8 * 28 * 28), (288, 128, 16 * 8 * 28 * 28),
                  (460, 256, 16 * 4 * 14 * 14), (576, 256, 16 * 4 * 14 * 14),
                  (921, 512, 16 * 2 * 7 * 7), (1152, 512, 16 * 2 * 7 * 7)]


def _assert_plan_covers(plan, rows, ci, co):
    """Every flat row, output channel and input channel lies in exactly one
    tile, and no tile lies wholly outside."""
    assert plan["rows"] == rows
    cut, per_cut, tile = (plan["rows_per_cut"], plan["tiles_per_cut"],
                          plan["tile_rows"])
    assert rows % cut == 0 and plan["row_tiles"] == rows // cut * per_cut
    row_hits = np.zeros(rows, np.int64)
    for start in range(0, rows, cut):  # tiles restart at every cut
        for i in range(per_cut):
            row_hits[start + i * tile:min(start + (i + 1) * tile,
                                          start + cut)] += 1
    co_hits = np.zeros(co, np.int64)
    for j in range(plan["co_tiles"]):
        co_hits[j * plan["tile_co"]:(j + 1) * plan["tile_co"]] += 1
    ci_hits = np.zeros(ci, np.int64)
    for k in range(plan["ci_steps"]):
        ci_hits[k * plan["tile_ci"]:(k + 1) * plan["tile_ci"]] += 1
    assert (row_hits == 1).all() and (co_hits == 1).all()
    assert (ci_hits == 1).all()
    assert (per_cut - 1) * tile < cut
    assert (plan["co_tiles"] - 1) * plan["tile_co"] < co
    assert (plan["ci_steps"] - 1) * plan["tile_ci"] < ci
    assert plan["threads"] == plan["tile_rows"] * 2 <= 256
    assert plan["smem_bytes"] <= 232448


@pytest.mark.parametrize("ci,co,rows", NETWORK_TCONVS + [(8, 5, 97)])
def test_tile_plan_covers_every_row_and_channel_once(ci, co, rows):
    """The float32 plan (flat rows) and the bf16 plans (one frame of `rows`
    positions, and 2 x 3 frames of them) cover the output exactly once; the
    bf16 plan names the kernel by what fits in shared memory and the staging
    path by Ci and x's alignment."""
    plan = tile_plan(1, 1, rows, ci, co, torch.float32)
    assert plan["kernel"] == "f32_cuda_core" and plan["threads"] == 256
    _assert_plan_covers(plan, rows, ci, co)
    for n, t in ((1, 1), (2, 3)):
        plan = tile_plan(n, t, rows, ci, co)
        _assert_plan_covers(plan, n * t * rows, ci, co)
        # W's tile and four x tiles of 64 rows fit in 227 KB up to Ci = 256
        assert plan["kernel"] == ("resident" if ci <= 256 else "streamed")
        if plan["kernel"] == "resident":
            bulk = plan["staging"].startswith("bulk")
            assert plan["rows_per_cut"] == rows
            assert (3 if bulk else 4) <= plan["ring"] <= 6
            extra = (64 if plan["staging"] == "tma" else
                     64 + -(-plan["tile_rows"] * ci * 2 // 16) * 16 if bulk
                     else 0)
            assert plan["smem_bytes"] == 1024 + plan["ci_pad"] // 64 * 8192 * (
                3 + plan["ring"] * plan["wgs"]) + plan["wgs"] * 2048 + extra
        else:
            assert plan["rows_per_cut"] == rows and plan["tile_rows"] == 128
    def want(align):
        if ci % 8 == 0 and align >= 16:
            return "tma"
        narrow = "4" if ci % 2 == 0 and align >= 4 else "2"
        plan = tile_plan(1, 1, rows, ci, co, x_align=align)
        # one bulk copy per tile where its rows are an aligned run of x of a
        # multiple of 16 bytes (resident kernel only)
        if (plan["kernel"] == "resident" and align >= 16 and all(
                r * ci * 2 % 16 == 0
                for r in (rows, plan["tile_rows"],
                          rows % plan["tile_rows"]))):
            return "bulk" + narrow
        return "cp.async4" if narrow == "4" else "scalar"

    # a view at a 4- or 2-byte offset narrows the accesses
    for align in (16, 4, 2):
        assert tile_plan(1, 1, rows, ci, co, x_align=align)["staging"] == (
            want(align))
    if ci in (45, 230):  # the large ragged shapes of the network
        assert want(16).startswith("bulk")


@pytest.mark.parametrize("ci,staging", [(144, "tma"),
                                        (230, "cp.async4"),
                                        (921, "scalar"), (45, "scalar")])
def test_tile_plan_names_the_staging_path(ci, staging):
    assert tile_plan(16, 2, 49, ci, 64)["staging"] == staging


def test_wrapper_dispatch_and_validation():
    x, w = _operands((1, 2, 3, 3, 4), 5)
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    # a CPU tensor takes the plain version, and only because it is on the CPU
    assert torch.equal(temporal_conv3(xt, wt, torch.float32),
                       temporal_conv3_plain(xt, wt))
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        temporal_conv3_cuda(xt, wt)
    with pytest.raises(ValueError, match="no temporal conv for device"):
        temporal_conv3(xt.to("meta"), wt.to("meta"), torch.float32)
    with pytest.raises(ValueError, match="w must be"):
        temporal_conv3_plain(xt, wt[:, :, :, :3])
    with pytest.raises(ValueError, match="x must be"):
        temporal_conv3_plain(xt[0], wt)
    with pytest.raises(ValueError, match="share one of"):
        temporal_conv3_plain(xt, wt.to(torch.bfloat16))
    with pytest.raises(ValueError, match="compute_dtype"):
        temporal_conv3(xt, wt, torch.float16)


def test_weight_crosses_the_bridge_both_ways():
    """[3, 1, 1, Ci, Co] <-> a Conv3d weight [Co, Ci, 3, 1, 1]: the Conv3d
    with the bridged weight computes what the op computes, and the way back
    returns the same array."""
    x, w = _operands((2, 4, 3, 3, 6), 7, seed=4)
    wt = bridge.conv_weight_from_jax(w)
    assert tuple(wt.shape) == (7, 6, 3, 1, 1) and wt.is_contiguous()
    conv = torch.nn.Conv3d(6, 7, (3, 1, 1), padding=(1, 0, 0), bias=False)
    with torch.no_grad():
        conv.weight.copy_(wt)
        want = conv(torch.from_numpy(x).permute(0, 4, 1, 2, 3)).permute(
            0, 2, 3, 4, 1)
    got = temporal_conv3(torch.from_numpy(x), torch.from_numpy(w),
                         torch.float32)
    np.testing.assert_allclose(got.detach().numpy(), want.numpy(),
                               atol=1e-5, rtol=1e-5)
    back = bridge.conv_weight_to_jax(conv.weight)
    assert back.shape == w.shape and back.tobytes() == w.tobytes()
    with pytest.raises(ValueError, match="5 axes"):
        bridge.conv_weight_from_jax(w[0])
    with pytest.raises(ValueError, match="5 axes"):
        bridge.conv_weight_to_jax(conv.weight[0])
