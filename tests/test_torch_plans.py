"""The launch plans of the port's redesigned kernels, which are plain
Python and so testable without a GPU: K2's cuts of a [n / C, C] tensor
(ops/bn_cuda.fwd_plan, bwd_plan, which the BN statistics' sums take too) as
properties over every epilogue shape of r2plus1d_18 and X3D-M and over
random (n, C), numpy walks of the kernels' index and
summation schemes under those plans against the plain versions, K1's and
K4's bands and staging (ops/resample_cuda.transform_plan, one plan for the
one kernel template) walked in numpy over the pipeline's canvases and the
SUN path's images against the plain transforms, and K3's resident plan
filling the card."""

import importlib.util
import itertools
import os

import numpy as np
import pytest
import torch

from zeroshotvideoclassification_tpu_torch.ops.bn_cuda import (
    bn_apply_relu_plain,
    bwd_plan,
    fold_affine,
    fwd_plan,
)
from zeroshotvideoclassification_tpu_torch.ops.resample import (
    fused_image_motion_transform,
    fused_video_transform,
)
from zeroshotvideoclassification_tpu_torch.ops.resample_cuda import (
    K1_SMEM_MAX,
    k1_smem_bytes,
    transform_plan,
)
from zeroshotvideoclassification_tpu_torch.ops.temporal_conv import tile_plan

# [N, T, H, W, C] of every BN epilogue of r2plus1d_18 at 16 clips of
# 16x112x112 (the stem's two, then each stage's midplanes and planes)
EPILOGUES = [(16, 16, 56, 56, 45), (16, 16, 56, 56, 64),
             (16, 16, 56, 56, 144), (16, 8, 28, 28, 230),
             (16, 8, 28, 28, 128), (16, 8, 28, 28, 288),
             (16, 4, 14, 14, 460), (16, 4, 14, 14, 256),
             (16, 4, 14, 14, 576), (16, 2, 7, 7, 921), (16, 2, 7, 7, 512),
             (16, 2, 7, 7, 1152)]
# the same at 32 clips (the serving forward at bucket 8 x 4 clips)
EPILOGUES_32 = [(32, *shape[1:]) for shape in EPILOGUES]
# and at 64 clips (the train cell's step), where the BN statistics' sums
# (ops/bn_stats.py) take bwd_plan and their gradient fwd_plan
EPILOGUES_64 = [(64, *shape[1:]) for shape in EPILOGUES]
# the distinct BN shapes of X3D-M at its train cell's 64 clips of
# 16x224x224 (models/x3d.py: the stem's 24 at 112x112, then each stage's
# inner width before and after its strided conv_b, its width, the head's
# 432), 54 and 108 channels no multiple of the 8-lane bf16 vector
X3D_64 = [(64, 16, 112, 112, 24), (64, 16, 112, 112, 54),
          (64, 16, 56, 56, 54), (64, 16, 56, 56, 24),
          (64, 16, 56, 56, 108), (64, 16, 28, 28, 108),
          (64, 16, 28, 28, 48), (64, 16, 28, 28, 216),
          (64, 16, 14, 14, 216), (64, 16, 14, 14, 96),
          (64, 16, 14, 14, 432), (64, 16, 7, 7, 432), (64, 16, 7, 7, 192)]


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
@pytest.mark.parametrize("shape", EPILOGUES + EPILOGUES_64 + X3D_64)
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
    the in-block fold by channel, the strided second pass; K2 backward's
    and the BN statistics' sums', csrc/bn_common.cuh) in numpy gives each
    channel's plain sum: no element is dropped or counted twice, the ragged
    last folded row included."""
    g = np.random.default_rng(rows + c).normal(size=rows * c)
    plan = bwd_plan(rows * c, c, itemsize, aligned)
    got = _walk_sums(g, c, plan)
    np.testing.assert_allclose(got, g.reshape(rows, c).sum(0), rtol=1e-9,
                               atol=1e-9)


def _assert_fwd_plan(n, c, itemsize, aligned):
    plan = fwd_plan(n, c, itemsize, aligned)
    wf, vec = plan["wf"], plan["vec"]
    assert wf % c == 0 and wf == plan["m"] * c and plan["m"] >= 1
    assert plan["path"] == ("vector16" if aligned else "scalar")
    assert vec == (16 // itemsize if aligned else 1) and wf % vec == 0
    # every column group is some thread's, in blocks of whole warps
    threads, tiles = plan["threads"], plan["col_tiles"]
    assert threads % 32 == 0 and 32 <= threads <= 512
    assert tiles * threads * vec >= wf > (tiles - 1) * threads * vec
    # the chunks cover every folded row, the last one not empty
    rows = -(-n // wf)
    assert plan["chunks"] * plan["rows_per_chunk"] >= rows
    assert (plan["chunks"] - 1) * plan["rows_per_chunk"] < rows
    assert 1 <= plan["chunks"] <= 65535
    if n >= 2 ** 22:  # no reduction caps the blocks: the card is filled
        assert tiles * plan["chunks"] >= 132
    return plan


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("shape", EPILOGUES + EPILOGUES_32 + EPILOGUES_64
                         + X3D_64)
def test_fwd_plan_at_every_epilogue_of_the_model(shape, itemsize, aligned):
    n, c = int(np.prod(shape)), shape[-1]
    plan = _assert_fwd_plan(n, c, itemsize, aligned)
    cols = plan["wf"] // plan["vec"]
    assert cols / (plan["col_tiles"] * plan["threads"]) >= 0.9  # few idle
    if aligned:  # the folded view is the backward's, which its tests hold
        ref = bwd_plan(n, c, itemsize, aligned)
        assert (plan["wf"], plan["threads"], plan["col_tiles"]) == (
            ref["wf"], ref["threads"], ref["col_tiles"])
        # a thread walks at most 8 folded rows, two at a time where it can
        assert plan["rows_per_chunk"] <= 8


@pytest.mark.parametrize("seed", range(8))
def test_fwd_plan_properties_at_random_shapes(seed):
    rng = np.random.default_rng(50 + seed)
    for _ in range(40):
        c = int(rng.integers(1, 1400))
        n = int(rng.integers(1, 3000)) ** int(rng.integers(1, 3)) * c
        for itemsize in (2, 4):
            for aligned in (True, False):
                _assert_fwd_plan(n, c, itemsize, aligned)
    plan = _assert_fwd_plan(2 ** 31 + 144 * 1000, 144, 2, True)  # 64-bit
    assert plan["rows_per_chunk"] > 8  # the 65535 chunks bind


def _walk_fwd(x, r, a, b, relu, plan):
    """The forward kernel's index scheme under `plan`, in numpy float32:
    each thread's `vec` columns j of the folded [rows, wf] view (channel
    (j + k) % C, its a and b), its chunk's rows two at a time, then one, then
    the ragged last row element by element. -> (y, how often each element
    was written)."""
    n, c = x.size, a.size
    wf, vec, threads = plan["wf"], plan["vec"], plan["threads"]
    rows, full = -(-n // wf), n // wf
    firsts = np.array([(tile * threads + t) * vec
                       for tile in range(plan["col_tiles"])
                       for t in range(threads)])
    firsts = firsts[firsts < wf]                       # threads with columns
    cols = firsts[:, None] + np.arange(vec)[None, :]   # [threads, vec]
    ch = cols % c
    y = np.zeros(n, np.float32)
    writes = np.zeros(n, np.int64)

    def rows_out(rs, ragged=False):
        i = (np.asarray(rs)[:, None, None] * wf + cols[None]).reshape(-1)
        k = np.broadcast_to(ch[None], (len(rs), *ch.shape)).reshape(-1)
        if ragged:
            k, i = k[i < n], i[i < n]
        v = x[i] * a[k] + b[k]
        if r is not None:
            v = v + r[i]
        if relu:
            v = np.where(v < 0, np.float32(0), v)  # NaN passes
        y[i] = v
        np.add.at(writes, i, 1)

    for chunk in range(plan["chunks"]):
        r0 = chunk * plan["rows_per_chunk"]
        r1 = min(r0 + plan["rows_per_chunk"], rows)
        r1_full = max(min(r1, full), r0)
        row = r0
        while row + 2 <= r1_full:
            rows_out([row, row + 1])
            row += 2
        while row < r1_full:
            rows_out([row])
            row += 1
        while row < r1:
            rows_out([row], ragged=True)
            row += 1
    return y, writes


@pytest.mark.parametrize("rows,c,itemsize,aligned,res,relu", [
    (4 * 3 * 9 * 11, 45, 2, True, True, True),
    (4 * 3 * 9 * 11, 921, 2, True, False, True),
    (1000, 230, 4, True, True, False), (333, 144, 2, False, True, True),
    (77, 1152, 2, True, False, False), (5000, 7, 4, True, True, True),
    (1, 64, 2, True, False, True), (12345, 64, 2, True, True, True),
    (3, 3, 4, False, False, False)])
def test_fwd_index_scheme_gives_the_plain_version(rows, c, itemsize,
                                                  aligned, res, relu):
    """Walking the forward kernel's scheme in numpy gives
    bn_apply_relu_plain's float32 output bit for bit, every element written
    once (the ragged last folded row included; a NaN passes the ReLU)."""
    rng = np.random.default_rng(rows + c)
    x = rng.normal(size=rows * c).astype(np.float32)
    x[::97] = np.nan
    r = rng.normal(size=rows * c).astype(np.float32) if res else None
    stats = [torch.from_numpy(v.astype(np.float32)) for v in (
        rng.uniform(0.5, 2, c), rng.normal(size=c), rng.normal(size=c),
        rng.uniform(0.3, 3, c))]
    a, b = (v.numpy() for v in fold_affine(*stats, 1e-5))
    plan = fwd_plan(rows * c, c, itemsize, aligned)
    got, writes = _walk_fwd(x, r, a, b, relu, plan)
    want = bn_apply_relu_plain(
        torch.from_numpy(x).view(rows, c), *stats,
        None if r is None else torch.from_numpy(r).view(rows, c), relu)
    assert (writes == 1).all()
    np.testing.assert_array_equal(got, want.reshape(-1).numpy())


def _align16(v):
    return -(-v // 16) * 16


def _pieces(g0, nbytes):
    """The 16-byte pieces a run of `nbytes` at address g0 is copied in (the
    kernel's stage_run and tile write): each piece's [lo, hi) byte range,
    whole ones vector-wide, cut ones at either end; -> (ga, mis, ranges)."""
    ga = g0 & ~15
    starts = ga + 16 * np.arange((g0 + nbytes - ga + 15) // 16)
    lo, hi = np.maximum(starts, g0), np.minimum(starts + 16, g0 + nbytes)
    assert (hi > lo).all() and (lo[1:] == hi[:-1]).all()
    assert lo[0] == g0 and hi[-1] == g0 + nbytes  # each byte exactly once
    whole = (hi - lo) == 16
    assert whole[1:-1].all()                      # cut pieces only at ends
    return ga, g0 - ga


def _walk_bands(canvas, taps, plan, canvas_addr=0, out_addr=0, itemsize=4,
                affine=None):
    """The band scheme of csrc/video_transform.cu under `plan` in numpy
    float32, block by block of the grid (band x, frame y): K1 on a canvas
    [B, T, Hc, Wc, 3] with taps [B, S], or, with `affine` = (scale,
    offset), K4 on images [B, Hc, Wc, 3] with per-frame taps [B, T, S].
    The band's taps; where its span fits stage_rows, the span staged at
    once, else pieces (runs of output rows whose span fits, or the pair of
    rows of one output row), each staged and computed in turn. Rows are
    staged at their address's 16-byte phase in a staging area of the
    planned size (unstaged bytes read as -1 and fail, and a pixel's two
    words must lie inside the area), the pixels computed in the plain
    version's order (bytes made floats by the kernel's add; K1's /2 as *
    0.5) into a tile at the output's phase, which leaves in 16-byte pieces.
    -> (out [B, T, S, S, 3], how often each element was written)."""
    y0, y1, wy, x0, x1, wx = (np.asarray(a) for a in taps)
    if affine is None:
        nb, nt, hc, wc, _ = canvas.shape
    else:
        (nb, hc, wc, _), nt = canvas.shape, y0.shape[1]
    s, band, cap = y0.shape[-1], plan["band_rows"], plan["stage_rows"]
    # a frame's row of taps: its sample's (K1) or its own (K4)
    y0, y1, wy, x0, x1, wx = (a.reshape(-1, s) for a in (y0, y1, wy, x0, x1,
                                                          wx))
    rowb = wc * 3
    assert plan["smem_bytes"] == k1_smem_bytes(band, cap, s, wc, itemsize)
    assert plan["smem_bytes"] <= K1_SMEM_MAX
    assert plan["blocks"] == nb * nt * plan["bands"]
    assert (plan["bands"] - 1) * band < s <= plan["bands"] * band
    flat = canvas.reshape(-1)
    out = np.zeros(nb * nt * s * s * 3, np.float32)
    writes = np.zeros(out.size, np.int64)
    one = np.float32(1)
    for frame, oy0 in itertools.product(range(nb * nt),
                                        range(0, plan["bands"] * band, band)):
        b = frame // nt if affine is None else frame
        src_frame = frame if affine is None else frame // nt
        xa = np.clip(x0[b], 0, wc - 1) * 3
        xb = np.clip(x1[b], 0, wc - 1) * 3
        fx = wx[b]
        gx = one - fx
        nrows = min(band, s - oy0)
        ya = np.clip(y0[b, oy0:oy0 + nrows], 0, hc - 1)
        yb = np.clip(y1[b, oy0:oy0 + nrows], 0, hc - 1)
        fy = wy[b, oy0:oy0 + nrows]
        go = out_addr + (frame * s + oy0) * s * 3 * itemsize
        go_mis = (go % 16) // itemsize
        first = (go - out_addr) // itemsize
        tile = np.full(_align16(band * s * 3 * itemsize + 16) // itemsize,
                       np.nan, np.float32)
        stage = np.full(_align16(cap * rowb + 64), -1, np.int16)

        def stage_run(area, row, nrow):
            """Source rows row.. of the frame into the staging area from
            byte `area` on, at their address's 16-byte phase; -> where
            they start."""
            src = (src_frame * hc + row) * rowb
            _, mis = _pieces(canvas_addr + src, nrow * rowb)
            assert area + mis + nrow * rowb <= stage.size
            stage[area + mis:area + mis + nrow * rowb] = (
                flat[src:src + nrow * rowb])
            return area + mis

        def compute(i0, i1, ra, rb):
            wyv = fy[i0:i1, None, None]
            gy = one - wyv
            c3 = np.arange(3)[None, None, :]

            def px(base, col):
                off = base[:, None, None] + col[None, :, None] + c3
                v = stage[off]
                assert (v >= 0).all(), "read a byte that was not staged"
                # the kernel reads the two words that hold a pixel's bytes
                assert (off // 4 * 4 + 8 <= stage.size).all()
                # the kernel's byte_value: 2^23 + b, less 2^23
                bits = np.uint32(0x4B000000) | v.astype(np.uint32)
                return bits.view(np.float32) - np.float32(2 ** 23)

            ca = px(ra, xa) * gy + px(rb, xa) * wyv
            cb = px(ra, xb) * gy + px(rb, xb) * wyv
            v = ca * gx[None, :, None] + cb * fx[None, :, None]
            if affine is None:
                v = ((v / np.float32(255)) - one) * np.float32(0.5)
            else:
                v = v * affine[0] + affine[1]
            e0 = go_mis + i0 * s * 3
            tile[e0:e0 + v.size] = v.reshape(-1)

        lo, hi = min(ya.min(), yb.min()), max(ya.max(), yb.max())
        if hi - lo + 1 <= cap:  # the span at once
            slot = stage_run(0, lo, hi - lo + 1)
            compute(0, nrows, slot + (ya - lo) * rowb, slot + (yb - lo) * rowb)
        i0 = 0 if hi - lo + 1 > cap else nrows
        while i0 < nrows:  # else in pieces
            lo, hi = min(ya[i0], yb[i0]), max(ya[i0], yb[i0])
            pair = hi - lo + 1 > cap
            i1 = i0 + 1
            while not pair and i1 < nrows:
                nlo = min(lo, ya[i1], yb[i1])
                nhi = max(hi, ya[i1], yb[i1])
                if nhi - nlo + 1 > cap:
                    break
                lo, hi, i1 = nlo, nhi, i1 + 1
            stage[:] = -1
            if pair:
                ra = np.full(i1 - i0, stage_run(0, ya[i0], 1))
                b_at = _align16(rowb + 16)
                rb = np.full(i1 - i0, stage_run(b_at, yb[i0], 1))
            else:
                slot = stage_run(0, lo, hi - lo + 1)
                ra = slot + (ya[i0:i1] - lo) * rowb
                rb = slot + (yb[i0:i1] - lo) * rowb
            compute(i0, i1, ra, rb)
            i0 = i1
        n_el = nrows * s * 3
        _pieces(go, n_el * itemsize)
        out[first:first + n_el] = tile[go_mis:go_mis + n_el]
        writes[first:first + n_el] += 1
    return out.reshape(nb, nt, s, s, 3), writes


def _pipeline_batch(tmp_path, validation, n_clips, bs):
    """A batch of the port's HostPipeline over seeded synthetic .npy clips
    (serving: validation, 4 clips; training: random crops and flips), with
    the column taps of every other sample mirrored (a flip) on top."""
    from torch_helpers import synthetic_clip
    from zeroshotvideoclassification_tpu_torch.config import Config
    from zeroshotvideoclassification_tpu_torch.data.datasets import VideoTable
    from zeroshotvideoclassification_tpu_torch.data.pipeline import (
        HostPipeline,
    )

    paths = []
    for k in range(bs):
        p = tmp_path / f"v{k}.npy"
        np.save(p, synthetic_clip(k, 16 * n_clips, 240, 320))
        paths.append(str(p))
    cfg = Config(size=112, clip_len=16, n_clips=n_clips, prefetch_depth=0)
    table = VideoTable(name="t", fnames=np.asarray(paths, object),
                       label_idx=np.zeros(bs, np.int32), classes=["a"],
                       class_embed=np.ones((1, 300), np.float32),
                       loader="npy", is_validation=validation,
                       n_clips=n_clips)
    hb = next(iter(HostPipeline(table, cfg, bs, seed=3)))
    taps = [a.copy() for a in (hb.y0, hb.y1, hb.wy, hb.x0, hb.x1, hb.wx)]
    for j in (3, 4, 5):
        taps[j][1::2] = taps[j][1::2, ::-1]
    return hb.canvas, taps


def _odd_case(seed, b=2, t=3, hc=131, wc=173, shuffle=False):
    from zeroshotvideoclassification_tpu_torch.data.transform_params import (
        make_transform_params,
        resample_indices,
    )

    rng = np.random.default_rng(seed)
    canvas = rng.integers(0, 256, (b, t, hc, wc, 3), dtype=np.uint8)
    p = make_transform_params(np.array([[hc - 10, wc - 6]] * b), 112, False,
                              rng)
    p.flip[:] = np.arange(b) % 2 == 1
    taps = list(resample_indices(p, 112).astuple())
    if shuffle:  # taps that are not monotone: every row from anywhere
        for j in (0, 1, 2):
            taps[j] = taps[j][:, rng.permutation(taps[j].shape[1])]
        taps[1] = rng.integers(0, hc, taps[1].shape).astype(np.int32)
    return canvas, taps


def _assert_k1_walk(canvas, taps, plan, **addr):
    got, writes = _walk_bands(canvas, taps, plan, **addr)
    want = fused_video_transform(
        *(torch.from_numpy(np.ascontiguousarray(a)) for a in (canvas, *taps)))
    assert (writes == 1).all()
    np.testing.assert_array_equal(got, want.numpy())


@pytest.mark.parametrize("case", ["serve", "train"])
def test_k1_band_scheme_on_the_pipeline_canvases(tmp_path, case):
    """K1's bands, staging and 16-byte writes walked in numpy under
    transform_plan on the canvases data/pipeline builds (the 226 x 226
    window; serving 4 clips a video, training random crops and flips):
    bit for bit the plain float32 transform, every output written once, a
    band's source rows staged in one piece."""
    canvas, taps = _pipeline_batch(tmp_path, case == "serve",
                                   4 if case == "serve" else 1,
                                   2 if case == "serve" else 4)
    b, t, hc, wc, _ = canvas.shape
    assert (hc, wc) == (226, 226)
    plan = transform_plan(b, t, hc, wc, 112, 4)
    assert (plan["band_rows"], plan["bands"]) == (16, 7)
    assert plan["smem_bytes"] <= 96 * 1024  # two blocks an SM at least
    for j in range(b):  # every band's span fits: no pieces at these taps
        for oy0 in range(0, 112, 16):
            rows = np.r_[taps[0][j, oy0:oy0 + 16], taps[1][j, oy0:oy0 + 16]]
            assert rows.max() - rows.min() + 1 <= plan["stage_rows"]
    _assert_k1_walk(canvas, taps, plan)


@pytest.mark.parametrize("shuffle,stage_rows,addr", [
    (False, None, {}), (False, None, {"canvas_addr": 5, "out_addr": 4}),
    (True, None, {}), (True, 5, {"canvas_addr": 3}), (False, 2, {}),
    (True, 2, {"canvas_addr": 9, "out_addr": 8})])
def test_k1_band_scheme_on_an_odd_canvas(shuffle, stage_rows, addr):
    """The odd 131 x 173 canvas, taps monotone or not, at staging areas of
    the planned size and of 5 and 2 rows (which force pieces and the pair
    of rows), and at addresses off the 16-byte grid: bit for bit the plain
    float32 transform, every output written once, no unstaged byte read."""
    canvas, taps = _odd_case(7, shuffle=shuffle)
    plan = dict(transform_plan(*canvas.shape[:4], 112, 4))
    if stage_rows is not None:
        plan["stage_rows"] = stage_rows
        plan["smem_bytes"] = k1_smem_bytes(plan["band_rows"], stage_rows,
                                           112, canvas.shape[3], 4)
    _assert_k1_walk(canvas, taps, plan, **addr)


@pytest.mark.parametrize("shape", [
    (8, 64, 226, 226, 112), (16, 16, 226, 226, 112), (2, 3, 131, 173, 112),
    (1, 1, 2000, 8000, 112), (1, 1, 10, 38000, 112), (3, 5, 400, 226, 112),
    (65535, 1, 8, 8, 4), (1, 1, 5, 5, 200), (1, 1, 1, 1, 1)])
@pytest.mark.parametrize("itemsize", [2, 4])
def test_transform_plan_fits_any_canvas(shape, itemsize):
    """Any canvas gets a plan within a block's 227 KB of shared memory that
    stages at least the two rows of one output row (the whole span of a
    band wherever a crop inside the canvas allows it), a block per band
    and frame, and whole warps that waste the fewest threads on a row of
    s columns; B * T past 65535 and a row too wide for that raise."""
    b, t, hc, wc, s = shape
    plan = transform_plan(b, t, hc, wc, s, itemsize)
    assert plan["smem_bytes"] == k1_smem_bytes(
        plan["band_rows"], plan["stage_rows"], s, wc, itemsize)
    assert plan["smem_bytes"] <= K1_SMEM_MAX and plan["stage_rows"] >= 2
    if wc <= 400:  # the pipeline's canvases and others of that order
        assert plan["whole_span"]
    assert 1 <= plan["band_rows"] <= min(s, 16)
    assert plan["bands"] == -(-s // plan["band_rows"])
    assert plan["frames"] == b * t
    assert plan["blocks"] == b * t * plan["bands"]
    threads = plan["threads"]
    assert threads % 32 == 0 and 32 <= threads <= 256
    if s <= 256:  # whole rows a block, at most one warp's worth idle
        assert threads - threads // s * s < 32 or threads == 256
    assert (plan["per_sm"] * (plan["smem_bytes"] + 1024) <= 233472
            and plan["per_sm"] * threads <= 2048)
    with pytest.raises(ValueError, match="65535"):
        transform_plan(65536, 1, hc, wc, s, itemsize)
    with pytest.raises(ValueError, match="shared memory"):
        transform_plan(1, 1, hc, 40000, s, itemsize)


def _sun_images(seed, b, t, s=112, canvas=(256, 342), sizes=None,
                trajectory=None, shuffle=False):
    """K4's operands as the SUN path builds them: b seeded images on the
    canvas in several true sizes ((100, 340): side-112 boxes overhang it),
    and for each of t frames a crop box turned into taps by the port's host
    functions ([b, t, s] each); `shuffle` makes the row taps non-monotone
    and puts every second row tap anywhere in the canvas."""
    from zeroshotvideoclassification_tpu_torch.data.stillimages import (
        camera_motion_trajectory,
        motion_resample_indices,
    )

    rng = np.random.default_rng(seed)
    hc, wc = canvas
    sizes = sizes or [(hc, wc), (200, 260), (256, 300), (172, 342),
                      (100, 340)]
    images = np.zeros((b, hc, wc, 3), np.uint8)
    taps = [[] for _ in range(6)]
    for k in range(b):
        h, w = sizes[k % len(sizes)]
        images[k, :h, :w] = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        traj = (camera_motion_trajectory((h, w), s, t, rng)
                if trajectory is None else np.asarray(trajectory))
        for lst, a in zip(taps, motion_resample_indices(traj, (h, w), s)):
            lst.append(a)
    taps = [np.ascontiguousarray(np.stack(a)) for a in taps]
    if shuffle:
        perm = rng.permutation(s)
        for j in (0, 1, 2):
            taps[j] = np.ascontiguousarray(taps[j][..., perm])
        taps[1] = rng.integers(0, hc, taps[1].shape).astype(np.int32)
    return images, taps


def _band_spans(y0, y1, band):
    """The span of source rows each band of each frame touches."""
    s = y0.shape[-1]
    rows = [np.concatenate([y0.reshape(-1, s)[:, o:o + band],
                            y1.reshape(-1, s)[:, o:o + band]], axis=1)
            for o in range(0, s, band)]
    return np.stack([r.max(1) - r.min(1) + 1 for r in rows])


@pytest.mark.parametrize("itemsize", [2, 4])
def test_k4_plan_at_the_sun_shape(itemsize):
    """K4 at the SUN path's shape (16 images of the 256 x 342 canvas, 16
    frames each, 112 x 112 out) takes K1's plan: bands of 16 output rows,
    7 a frame, within 96 KB of shared memory, and a staging area that holds
    the whole span of every band of 64 images' crop boxes (crop sides from
    112 to the image's short side), so no band is staged in pieces."""
    plan = transform_plan(16, 16, 256, 342, 112, itemsize)
    assert (plan["band_rows"], plan["bands"], plan["whole_span"]) == (
        16, 7, True)
    assert plan["blocks"] == 16 * 16 * 7 and plan["threads"] == 224
    assert plan["smem_bytes"] == k1_smem_bytes(16, plan["stage_rows"], 112,
                                               342, itemsize)
    assert plan["smem_bytes"] <= 96 * 1024 and plan["per_sm"] >= 3
    _, taps = _sun_images(0, 64, 16)
    spans = _band_spans(taps[0], taps[1], 16)
    assert spans.max() <= plan["stage_rows"], (spans.max(), plan)


@pytest.mark.parametrize("case", ["sun", "sun_bf16", "odd_s", "overhang",
                                  "shuffled", "pieces", "pair_off_grid"])
def test_k4_band_scheme_gives_the_plain_version(case):
    """K4's bands, staging and 16-byte writes walked in numpy under
    transform_plan: per-frame taps, one image per sample, the per-channel
    affine after the lerps, at the SUN canvas, an odd output side (97) on an
    odd canvas, crop boxes that overhang the image, non-monotone taps,
    staging areas of 5 and 2 rows (pieces and the pair of rows) and
    addresses off the 16-byte grid: bit for bit the plain float32
    transform, every output written once, no unstaged byte read."""
    from zeroshotvideoclassification_tpu_torch.data.stillimages import (
        CH_OFFSET,
        CH_SCALE,
    )
    from zeroshotvideoclassification_tpu_torch.ops.resample import (
        channel_affine,
    )

    kw, s, stage_rows, addr, itemsize = {}, 112, None, {}, 4
    if case == "sun_bf16":
        itemsize, addr = 2, {"out_addr": 6}
    elif case == "odd_s":
        s, kw = 97, {"canvas": (131, 173), "sizes": [(131, 173), (120, 150)]}
    elif case == "overhang":
        kw = {"canvas": (100, 400), "sizes": [(100, 400)],
              "trajectory": [[0, 5, 112], [0, 200, 112], [0, 300, 112]]}
    elif case in ("shuffled", "pieces", "pair_off_grid"):
        kw = {"shuffle": True}
        stage_rows = {"pieces": 5, "pair_off_grid": 2}.get(case)
        addr = {"pieces": {"canvas_addr": 3},
                "pair_off_grid": {"canvas_addr": 9, "out_addr": 8}}.get(
                    case, {})
    images, taps = _sun_images(11, 2, 3, s=s, **kw)
    plan = dict(transform_plan(2, 3, *images.shape[1:3], s, itemsize))
    if stage_rows is not None:
        plan["stage_rows"] = stage_rows
        plan["smem_bytes"] = k1_smem_bytes(plan["band_rows"], stage_rows, s,
                                           images.shape[2], itemsize)
    affine = channel_affine(CH_SCALE, CH_OFFSET)
    got, writes = _walk_bands(images, taps, plan, itemsize=itemsize,
                              affine=affine, **addr)
    want = fused_image_motion_transform(
        *(torch.from_numpy(a) for a in (images, *taps)), CH_SCALE, CH_OFFSET)
    assert (writes == 1).all()
    np.testing.assert_array_equal(got, want.numpy())
    if case == "overhang":  # the clamped extent repeats the last rows
        assert int(taps[1].max()) == 99
    if case in ("pieces", "pair_off_grid"):
        assert _band_spans(taps[0], taps[1], 16).max() > stage_rows


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


def test_profile_k1_switches_still_match_the_source():
    """tools/profile_k1.py times K1 with parts switched off by macros it
    writes into a copy of csrc/video_transform.cu: each anchor is found
    exactly once, and the copy carries every macro a variant names."""
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "tools", "profile_k1.py")
    spec = importlib.util.spec_from_file_location("profile_k1", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    text = mod.switched_source()
    for macros in mod.VARIANTS.values():
        for m in macros:
            assert f"EXP_{m}" in text, m
    assert set(mod.VARIANTS["nothing"]) == {
        m for v in mod.VARIANTS.values() for m in v}


def _div255_fused(v):
    """csrc/video_transform.cu's div255 on float32 `v` in numpy: q = v * r
    (r = 1 / 255 rounded), e = fma(-q, 255, v), q + e * r fused. The first
    fma is exact in float64; the second is rounded to float64 by
    round-to-odd (TwoSum's error sets the sticky bit), so its one rounding
    to float32 is the fma's."""
    r = np.float32(1) / np.float32(255)
    q = v * r
    e = (v.astype(np.float64) - q.astype(np.float64) * 255.0).astype(
        np.float32)
    p = e.astype(np.float64) * np.float64(r)      # exact: 48 bits
    q64 = q.astype(np.float64)
    s = q64 + p
    bb = s - q64
    err = (q64 - (s - bb)) + (p - bb)
    bits = s.view(np.int64).copy()
    sticky = (err != 0) & ((bits & 1) == 0)
    bits[sticky] += np.where((err[sticky] > 0) == (s[sticky] > 0), 1, -1)
    return bits.view(np.float64).astype(np.float32)


@pytest.mark.parametrize("lo,hi,step", [
    (0, 0x00800000, 61),              # zero and the subnormals
    (0x00800000, 0x43800000, 4093),   # normal floats up to 256
    (0x3F800000, 0x3F800000 + (1 << 20), 1),  # a run of [1, 2) in full
    (0x437F0000, 0x43800000, 1)])     # [255, 256) in full
def test_k1_division_by_255_in_fused_steps_is_exact(lo, hi, step):
    """K1 divides by 255 as a product and one fused correction (div255);
    its float32 output is bit-equal to the plain version only if that is
    the correctly rounded quotient. Checked here on samples of every float
    below 256 (the values a pixel can take) and on two runs in full; the
    same check at step 1 over all of them finds no difference either. The
    correction is what makes it exact: without it, or unfused, it is not."""
    bits = np.arange(lo, hi, step, dtype=np.uint32)
    v = bits.view(np.float32)
    want = v / np.float32(255)
    np.testing.assert_array_equal(_div255_fused(v).view(np.uint32),
                                  want.view(np.uint32))
    if lo >= 0x3F800000:
        r = np.float32(1) / np.float32(255)
        assert (v * r != want).any()
        q = v * r
        assert (q + (v - q * np.float32(255)) * r != want).any()
