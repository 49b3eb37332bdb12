"""The launch plans of the port's two redesigned kernels, which are plain
Python and so testable without a GPU: K2 backward's cut of a [n / C, C]
tensor (ops/bn_cuda.bwd_plan) as properties over every epilogue shape of
r2plus1d_18 and over random (n, C), a numpy walk of the kernels' summation
scheme under that plan against direct sums, and K3's resident plan filling
the card."""

import importlib.util
import os

import numpy as np
import pytest
import torch

from zeroshotvideoclassification_tpu_torch.ops.bn_cuda import bwd_plan
from zeroshotvideoclassification_tpu_torch.ops.temporal_conv import tile_plan

# [N, T, H, W, C] of every BN epilogue of r2plus1d_18 at 16 clips of
# 16x112x112 (the stem's two, then each stage's midplanes and planes)
EPILOGUES = [(16, 16, 56, 56, 45), (16, 16, 56, 56, 64),
             (16, 16, 56, 56, 144), (16, 8, 28, 28, 230),
             (16, 8, 28, 28, 128), (16, 8, 28, 28, 288),
             (16, 4, 14, 14, 460), (16, 4, 14, 14, 256),
             (16, 4, 14, 14, 576), (16, 2, 7, 7, 921), (16, 2, 7, 7, 512),
             (16, 2, 7, 7, 1152)]


def _assert_bwd_plan(n, c, itemsize, aligned):
    plan = bwd_plan(n, c, itemsize, aligned)
    wf, vec = plan["wf"], plan["vec"]
    assert wf % c == 0 and wf == plan["m"] * c and plan["m"] >= 1
    if aligned:  # the 16-byte path: 8 bf16 or 4 float32 columns a thread
        assert plan["path"] == "vector16" and vec == 16 // itemsize
    else:
        assert plan["path"] == "scalar" and vec == 1
    assert wf % vec == 0
    # the blocks across the width cover every column group, none idle
    threads, tiles = plan["threads"], plan["col_tiles"]
    assert threads % 32 == 0 and 32 <= threads <= 512
    assert tiles * threads * vec >= wf > (tiles - 1) * threads * vec
    # the chunks cover every folded row, the last one not empty
    rows = -(-n // wf)
    assert plan["chunks"] * plan["rows_per_chunk"] >= rows
    assert (plan["chunks"] - 1) * plan["rows_per_chunk"] < rows
    assert 1 <= plan["chunks"] <= 65535
    assert tiles * plan["chunks"] <= 264  # what pass 2 adds per channel
    return plan


@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("shape", EPILOGUES)
def test_bwd_plan_at_every_epilogue_of_the_model(shape, itemsize):
    n, c = int(np.prod(shape)), shape[-1]
    plan = _assert_bwd_plan(n, c, itemsize, True)
    # at the model's shapes the 16-byte path wastes few threads ...
    cols = plan["wf"] // plan["vec"]
    assert cols / (plan["col_tiles"] * plan["threads"]) >= 0.9
    # ... and the large tensors get enough blocks to fill 132 SMs
    if n >= 2 ** 22:
        assert plan["col_tiles"] * plan["chunks"] >= 132
    _assert_bwd_plan(n, c, itemsize, False)


@pytest.mark.parametrize("seed", range(16))
def test_bwd_plan_properties_at_random_shapes(seed):
    rng = np.random.default_rng(seed)
    for _ in range(40):
        c = int(rng.integers(1, 1400))
        rows = int(rng.integers(1, 3000)) ** int(rng.integers(1, 3))
        n = rows * c
        for itemsize in (2, 4):
            for aligned in (True, False):
                _assert_bwd_plan(n, c, itemsize, aligned)
    _assert_bwd_plan(2 ** 31 + 144 * 1000, 144, 2, True)  # the 64-bit case


def _walk_sums(g, c, plan):
    """The per-channel sum of g (flat [n], channel i % c) in the order the
    two kernels take under `plan`: thread by thread over its rows, the
    block's columns of a channel in column order, the blocks 32 strided
    lanes and a tree; float64, so that only the index arithmetic counts."""
    n, wf, vec = g.size, plan["wf"], plan["vec"]
    rows = -(-n // wf)
    padded = np.zeros(rows * wf)
    padded[:n] = g
    padded = padded.reshape(rows, wf)
    width = plan["threads"] * vec
    partial = np.zeros((plan["chunks"], plan["col_tiles"], c))
    for chunk in range(plan["chunks"]):
        r0 = chunk * plan["rows_per_chunk"]
        r1 = min(r0 + plan["rows_per_chunk"], rows)
        cols = padded[r0:r1].sum(0)  # each thread walks its own columns
        for tile in range(plan["col_tiles"]):
            j_lo, j_hi = tile * width, min((tile + 1) * width, wf)
            for ch in range(c):
                first = j_lo + (ch - j_lo % c + c) % c
                partial[chunk, tile, ch] = cols[first:j_hi:c].sum()
    flat = partial.reshape(-1, c)
    lanes = np.stack([flat[k::32].sum(0) if k < len(flat) else np.zeros(c)
                      for k in range(32)])
    return lanes.sum(0)


@pytest.mark.parametrize("rows,c,itemsize,aligned", [
    (4 * 3 * 9 * 11, 45, 2, True), (4 * 3 * 9 * 11, 921, 2, True),
    (1000, 230, 4, True), (333, 144, 2, False), (77, 1152, 2, True),
    (5000, 7, 4, True), (1, 64, 2, True), (12345, 64, 2, True)])
def test_bwd_summation_scheme_counts_every_element_once(rows, c, itemsize,
                                                        aligned):
    """Walking the kernels' scheme (folded rows, a thread's `vec` columns,
    the in-block fold by channel, the strided second pass) in numpy gives
    each channel's plain sum: no element is dropped or counted twice, the
    ragged last folded row included."""
    g = np.random.default_rng(rows + c).normal(size=rows * c)
    plan = bwd_plan(rows * c, c, itemsize, aligned)
    got = _walk_sums(g, c, plan)
    np.testing.assert_allclose(got, g.reshape(rows, c).sum(0), rtol=1e-9,
                               atol=1e-9)


@pytest.mark.parametrize("shape,co,kernel,staging", [
    ((16, 16, 56, 56, 144), 64, "resident", "tma"),
    ((16, 8, 28, 28, 230), 128, "resident", "bulk4"),
    ((16, 2, 7, 7, 921), 512, "streamed", "scalar"),
    ((16, 16, 56, 56, 45), 64, "resident", "bulk2"),
    ((16, 2, 7, 7, 1152), 512, "streamed", "tma")])
def test_tile_plan_at_the_shapes_the_card_run_times(shape, co, kernel,
                                                    staging):
    n, t, h, w, ci = shape
    plan = tile_plan(n, t, h * w, ci, co)
    assert (plan["kernel"], plan["staging"]) == (kernel, staging)
    if kernel == "resident":
        # whole waves of the 132 SMs: at layer1 64-row tiles (784 blocks,
        # 5.94 waves) beat 128-row tiles (400 blocks, 3.03 waves)
        blocks = n * plan["tiles_per_cut"] * plan["co_tiles"]
        assert blocks / (-(-blocks // 132) * 132) >= 0.75
    assert tile_plan(n, t, h * w, ci, co, torch.float32)["kernel"] == (
        "f32_cuda_core")


def test_profile_k3_switches_still_match_the_source():
    """tools/profile_k3.py times K3 with parts of the kernel switched off by
    macros it writes into a copy of the source: each of its anchors must be
    found exactly once in csrc/temporal_conv.cu (it raises otherwise), and
    the copy must carry every macro a variant names."""
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "tools", "profile_k3.py")
    spec = importlib.util.spec_from_file_location("profile_k3", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    text = mod.switched_source()
    for macros in mod.VARIANTS.values():
        for m in macros:
            assert f"EXP_{m}" in text, m
    assert set(mod.VARIANTS["nothing"]) == {
        m for v in mod.VARIANTS.values() for m in v}
