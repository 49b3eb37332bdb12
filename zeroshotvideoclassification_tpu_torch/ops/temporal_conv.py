"""K3: the (3,1,1) temporal convolution of R(2+1)D blocks as one op.

    y[n, t, h, w, :] = sum_{dt=0..2} x[n, t + dt - 1, h, w, :] @ W[dt, 0, 0]

stride 1, SAME padding in t (frames outside [0, T) count as zero), float32
accumulation, one rounding to the compute dtype. Counterpart of
zeroshotvideoclassification_tpu/ops/temporal_conv.py, in its layout: x is
[N, T, H, W, Ci] (NDHWC, the port's channels-last-3d seen through a permuted
view) and w is [3, 1, 1, Ci, Co] (DHWIO). As in the JAX package, no model
calls it: the networks' temporal convs go to cuDNN; this is the op kept
beside them for the comparison.

  temporal_conv3          the public op, a torch.autograd.Function: forward
                          is the kernel on CUDA tensors and the plain version
                          on CPU tensors (nothing falls back from one to the
                          other); backward is the gradient of the library
                          convolution (F.conv3d), as the JAX package's
                          custom_vjp takes the XLA convolution's: K3 never
                          had a backward kernel
  temporal_conv3_cuda     the forward kernels (csrc/temporal_conv.cu, replace
                          temporal_conv.py:_pallas_forward); launches counted
                          in `temporal_conv3_cuda.launches`
  temporal_conv3_plain    three shifted matrix products accumulated in
                          float32, plain PyTorch, any device and any strides
  tile_plan               which kernel a call takes and how it cuts the
                          output into blocks, in Python so that tests reach
                          it without a GPU

On the card the op is bound by bytes (layer1, bf16: 334 MB, 0.10 ms; its
44.4 GFLOP take half of that on the tensor cores), so the bf16 kernels
multiply with wgmma on operands in swizzled shared memory, and where one
64-channel tile of W and a ring of x tiles fit in a block's shared memory
("resident": Ci up to ~256) a block walks t in order and reads each x tile
from device memory once for its three taps; larger Ci streams 64-channel
slabs of x and W through a 4-stage ring ("streamed"). x reaches shared
memory by TMA (whole tiles, one thread asking) when Ci % 8 == 0 and x is
16-byte aligned; otherwise, in the resident kernel and where a tile's rows
are an aligned run of a multiple of 16 bytes, by one bulk copy of the tile
as it lies in x and a re-layout inside shared memory, else by 4-byte
cp.async (Ci even) or 2-byte loads; in both kernels a block's rows are positions of one frame, so a
tap outside [0, T) is skipped; W is first laid out K-major and zero-padded
by a small kernel of the same launch. Chains of at most 10 wgmma steps are
added outside the tensor cores (their accumulation truncates), and y leaves
as whole 128-byte lines. float32 keeps its CUDA-core kernel (full float32
products).
"""

from __future__ import annotations

import threading

import torch
import torch.nn.functional as F

from zeroshotvideoclassification_tpu_torch import _build

DTYPES = (torch.float32, torch.bfloat16)
# the tiles of csrc/temporal_conv.cu. float32: 128 output rows (n, t, p) by
# 64 output channels, staged 16 input channels at a time by 256 threads.
# bf16: 64 rows per warpgroup (one or two a block) by 64 channels, 16 input
# channels per wgmma, x and W in shared memory as slabs of 64 channels
TILE_ROWS, TILE_CO, TILE_CI, THREADS = 128, 64, 16, 256
WG_ROWS, WG_THREADS, SLAB = 64, 128, 64
MAX_SMEM = 232448          # 227 KB: the most one block may take
STREAM_STAGES = 4
OUT_STAGE = 2048           # a warpgroup's staging of its output rows
SM_COUNT = 132             # H100: what the resident plan fills in waves
_count_lock = threading.Lock()


def check_tconv_args(x, w):
    """Validate the op's operands; -> (N, T, H, W, Ci, Co)."""
    if x.dim() != 5:
        raise ValueError(f"x must be [N, T, H, W, Ci], got {tuple(x.shape)}")
    n, t, h, wd, ci = x.shape
    if w.dim() != 5 or tuple(w.shape[:4]) != (3, 1, 1, ci):
        raise ValueError(f"w must be [3, 1, 1, {ci}, Co], got "
                         f"{tuple(w.shape)}")
    if x.dtype not in DTYPES or w.dtype != x.dtype:
        raise ValueError(f"x and w must share one of {DTYPES}, got "
                         f"{x.dtype} and {w.dtype}")
    if w.device != x.device:
        raise ValueError(f"w is on {w.device}, x on {x.device}")
    return n, t, h, wd, ci, w.shape[4]


def _pad(v: int, m: int) -> int:
    return -(-v // m) * m


def tile_plan(n: int, t: int, p: int, ci: int, co: int,
              dtype=torch.bfloat16, x_align: int = 16):
    """Which kernel computes y [n * t * p, co] and how it cuts the work.

    Every plan has `rows`, `tile_rows`, `tile_co`, `tile_ci`, `threads`,
    `co_tiles` (runs of tile_co channels, the last ragged), `ci_steps`
    (steps of tile_ci input channels per temporal tap) and the row cut:
    the flat rows (n, t, p) fall into runs of `rows_per_cut`, each cut into
    `tiles_per_cut` tiles of tile_rows (the last ragged); `row_tiles` is
    their total and `blocks` the launch's grid. `kernel` is

      "f32_cuda_core"  float32: flat rows (rows_per_cut = rows)
      "resident"       bf16, W's 64-channel tile and a ring of `ring` x
                       tiles fit in shared memory: a block takes tile_rows
                       positions of one sample and walks its t frames
                       (rows_per_cut = p: tiles restart at every frame);
                       `wgs` warpgroups of 64 rows, chosen to fill the
                       card's SMs in whole waves
      "streamed"       bf16 otherwise: a block takes 128 positions of one
                       frame (rows_per_cut = p) and streams x and W
                       through a STREAM_STAGES-deep ring

    and `staging` how bf16 x reaches shared memory: "tma" (ci % 8 == 0 and
    x 16-byte aligned; `x_align` is the alignment of its pointer: whole
    tiles by the Tensor Memory Accelerator, one thread asking), "cp.async4"
    (ci even, x 4-byte aligned) or "scalar" (2-byte loads); in the resident
    kernel "bulk4" / "bulk2" instead of those two where x is 16-byte aligned
    and every tile's rows are a multiple of 16 bytes (one bulk copy of the
    tile as it lies in x, then moved 4 or 2 bytes at a time inside shared
    memory; `ring` may be 3 there);
    `smem_bytes` is the block's dynamic shared memory."""
    rows = n * t * p
    plan = {"rows": rows, "tile_co": TILE_CO, "tile_ci": TILE_CI,
            "co_tiles": -(-co // TILE_CO), "ci_steps": -(-ci // TILE_CI)}
    if dtype == torch.float32:
        plan.update(kernel="f32_cuda_core", staging="scalar",
                    tile_rows=TILE_ROWS, threads=THREADS, rows_per_cut=rows,
                    tiles_per_cut=-(-rows // TILE_ROWS), smem_bytes=0)
    else:
        if ci % 8 == 0 and x_align % 16 == 0:
            plan["staging"] = "tma"
        elif ci % 2 == 0 and x_align % 4 == 0:
            plan["staging"] = "cp.async4"
        else:
            plan["staging"] = "scalar"
        mbarriers = 64 if plan["staging"] == "tma" else 0
        # a tap of more than 10 steps of 16 channels runs as two wgmma chains
        # of 8 steps over 4 slabs (kMaxGroup in the source)
        slabs = 4 if 160 < ci <= 256 else _pad(ci, SLAB) // SLAB
        w_bytes = 3 * slabs * TILE_CO * 128
        best = None
        for wgs in (2, 1):
            tile_rows = wgs * WG_ROWS
            tile_bytes = slabs * tile_rows * 128
            # where TMA cannot serve and a tile's rows are one aligned run
            # of x of a multiple of 16 bytes, they come by one bulk copy
            # into a staging area and are moved into the slabs from there
            bulk = (plan["staging"] != "tma" and x_align % 16 == 0
                    and all(rows_ * ci * 2 % 16 == 0
                            for rows_ in (p, tile_rows, p % tile_rows)))
            extra = wgs * OUT_STAGE + (
                64 + _pad(tile_rows * ci * 2, 16) if bulk else mbarriers)
            ring = min(6, (MAX_SMEM - 1024 - w_bytes - extra) // tile_bytes)
            if ring < (3 if bulk else 4) or p == 0:
                continue
            p_tiles = -(-p // tile_rows)
            blocks = n * p_tiles * plan["co_tiles"]
            fill = (blocks / (-(-blocks // SM_COUNT) * SM_COUNT)
                    * p / (p_tiles * tile_rows))
            if best is None or fill > best[0] + 1e-9:
                best = (fill, wgs, ring, p_tiles,
                        1024 + w_bytes + ring * tile_bytes + extra, bulk)
        if best is not None:
            _, wgs, ring, p_tiles, smem, bulk = best
            if bulk:
                plan["staging"] = ("bulk4" if plan["staging"] == "cp.async4"
                                   else "bulk2")
            plan.update(kernel="resident", wgs=wgs, ring=ring,
                        ci_pad=slabs * SLAB,
                        tile_rows=wgs * WG_ROWS, threads=wgs * WG_THREADS,
                        rows_per_cut=p, tiles_per_cut=p_tiles,
                        smem_bytes=smem)
        else:
            plan.update(kernel="streamed", wgs=2, ring=STREAM_STAGES,
                        ci_pad=_pad(ci, SLAB),
                        tile_rows=TILE_ROWS, threads=THREADS,
                        rows_per_cut=p, tiles_per_cut=-(-p // TILE_ROWS),
                        smem_bytes=1024 + STREAM_STAGES * (
                            TILE_ROWS * 128 + TILE_CO * 128) + 64
                        + 2 * OUT_STAGE)
    cuts = rows // plan["rows_per_cut"] if plan["rows_per_cut"] else 0
    plan["row_tiles"] = cuts * plan["tiles_per_cut"]
    # a resident block walks the t frames of its tile
    plan["blocks"] = plan["co_tiles"] * (
        n * plan["tiles_per_cut"] if plan["kernel"] == "resident"
        else plan["row_tiles"])
    return plan


def temporal_conv3_plain(x, w):
    """The forward as plain PyTorch ops: x [N, T, H, W, Ci] and w
    [3, 1, 1, Ci, Co] of one dtype -> [N, T, H, W, Co] in that dtype."""
    check_tconv_args(x, w)
    xf, wf = x.float(), w[:, 0, 0].float()
    y = xf @ wf[1]
    y[:, 1:] += xf[:, :-1] @ wf[0]
    y[:, :-1] += xf[:, 1:] @ wf[2]
    return y.to(x.dtype)


_STAGING_BYTES = {"tma": 0, "cp.async4": 4, "scalar": 2,
                  "bulk4": 32 + 4, "bulk2": 32 + 2}  # the C entry's `mode`


def temporal_conv3_cuda(x, w):
    """The forward on the card: one launch of the float32 kernel, or of the
    bf16 pair (W's re-layout, then the tensor-core kernel `tile_plan`
    names); contiguous CUDA tensors only, x of any alignment (a view at an
    odd offset takes a narrower staging path); same contract as
    temporal_conv3_plain."""
    n, t, h, wd, ci, co = check_tconv_args(x, w)
    for name, v in (("x", x), ("w", w)):
        if not v.is_contiguous():
            raise ValueError(f"{name} must be contiguous (channels "
                             f"innermost) for the kernel")
    if x.device.type != "cuda":
        raise ValueError(f"temporal_conv3_cuda needs CUDA tensors, got "
                         f"{x.device}")
    align = x.data_ptr() & -x.data_ptr() if x.data_ptr() else 16
    plan = tile_plan(n, t, h * wd, ci, co, x.dtype, min(align, 16))
    if plan["row_tiles"] >= 2 ** 31 or plan["co_tiles"] > 65535:
        raise ValueError(f"{plan['row_tiles']} x {plan['co_tiles']} tiles "
                         f"exceed one launch's grid")
    y = torch.empty((n, t, h, wd, co), dtype=x.dtype, device=x.device)
    if y.numel() == 0:
        return y
    if ci == 0:
        return y.zero_()
    lib = _build.library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        if x.dtype == torch.float32:
            err = lib.zsvc_temporal_conv3_f32(
                x.data_ptr(), w.data_ptr(), y.data_ptr(), plan["rows"], t,
                h * wd, ci, co, plan["row_tiles"], plan["co_tiles"], stream)
        else:
            wt = torch.empty(3 * _pad(co, TILE_CO) * plan["ci_pad"],
                             dtype=x.dtype, device=x.device)
            err = lib.zsvc_temporal_conv3_bf16(
                x.data_ptr(), w.data_ptr(), y.data_ptr(), wt.data_ptr(), n,
                t, h * wd, ci, co, int(plan["kernel"] == "resident"),
                plan["wgs"], plan["ring"], _STAGING_BYTES[plan["staging"]],
                plan["smem_bytes"], stream)
    _build.check(err, "temporal_conv3")
    with _count_lock:
        temporal_conv3_cuda.launches += 1
    return y


temporal_conv3_cuda.launches = 0


def _library_conv(x, w):
    """The same convolution through F.conv3d (NDHWC in and out)."""
    y = F.conv3d(x.permute(0, 4, 1, 2, 3), w.permute(4, 3, 0, 1, 2),
                 padding=(1, 0, 0))
    return y.permute(0, 2, 3, 4, 1)


class _TemporalConv3(torch.autograd.Function):
    """Forward by the kernel (the plain version on the CPU), backward by the
    library convolution's gradient (jax.custom_vjp over lax.conv in
    temporal_conv.py:96-111)."""

    @staticmethod
    def forward(ctx, x, w):
        if x.device.type == "cuda":
            y = temporal_conv3_cuda(x, w)
        elif x.device.type == "cpu":
            y = temporal_conv3_plain(x, w)
        else:
            raise ValueError(f"no temporal conv for device {x.device}")
        ctx.save_for_backward(x, w)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        with torch.enable_grad():
            xg = x.detach().requires_grad_(ctx.needs_input_grad[0])
            wg = w.detach().requires_grad_(ctx.needs_input_grad[1])
            y = _library_conv(xg, wg)
        wanted = [v for v in (xg, wg) if v.requires_grad]
        grads = iter(torch.autograd.grad(y, wanted, dy))
        return tuple(next(grads) if need else None
                     for need in ctx.needs_input_grad)


def temporal_conv3(x, w, compute_dtype=torch.bfloat16):
    """Stride-1 SAME (3,1,1) conv, NDHWC: x [N, T, H, W, Ci] and w
    [3, 1, 1, Ci, Co] are cast to `compute_dtype` (float32 or bfloat16) and
    the result [N, T, H, W, Co] comes back in it; differentiable in x and
    w."""
    if compute_dtype not in DTYPES:
        raise ValueError(f"compute_dtype must be one of {DTYPES}, got "
                         f"{compute_dtype}")
    return _TemporalConv3.apply(x.to(compute_dtype).contiguous(),
                                w.to(compute_dtype).contiguous())
