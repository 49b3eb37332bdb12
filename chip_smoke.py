#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port: its serving path, its video
training path, its still-image (SUN) training path with the zero-shot
evaluation, the temporal conv op, the other models and options of the
trainer: C3D (trained and served), resnet18 (R3D-18 + the linear head),
--remat full / convs and --fixconvs, data-parallel training across
processes (one GPU, or two where the host shows two), K train steps a
dispatch as CUDA graphs (--steps_per_call), the head's tensor
parallelism (--tp), the serving engine over replicas, the multi-device
dry run, --save_samples and the checkpoint-porting tool.

    python3 chip_smoke.py [--json PATH]

Phases, each printing its own lines and aborting the run (non-zero exit, no
result line) if it fails:

  1. environment: torch / CUDA versions, the card's name and power limit
     (nvidia-smi), nvcc, whether triton imports;
  2. build: the CUDA kernels in zeroshotvideoclassification_tpu_torch/csrc
     with nvcc for sm_90a, timed;
  3. kernels against their plain PyTorch versions on the card, TF32 off:
     K1 (video transform) at the serving shape, buckets 8 and 32, in f32
     (atol 2e-6) and bf16 (1 ulp); K2 (BN epilogue) at every epilogue shape
     r2plus1d_18 produces at bucket 8 x 4 clips, f32 and bf16, with and
     without residual and ReLU. The wrapper's time (one call between two
     CUDA events, median) beside its launch alone (ops' *_prepare: the
     output allocated once, a run of LAUNCH_RUN launches between two
     events, per launch) and the plain time; for K2 also F.batch_norm
     (eval mode, channels-last, same dtype; the port never calls it) at the
     epilogues with neither residual nor ReLU, beside the kernel there;
  4. whole model: full-width r2plus1d_18 + mlp head, seeded weights with
     per-channel BN statistics (seeded scale and bias, running mean and
     variance measured on the clips), on the card in bf16 (the kernels'
     path) and in f32, each against the plain CPU f32 forward of the same
     clips;
  5. serve: the port's InferenceEngine (bf16, max_batch 32) behind the
     port's HTTP server; two rounds of three concurrent POST /classify (1,
     5 and 10 videos), GET /healthz and /stats; every result checked
     against a direct f32 classification, the kernels' launch counts read
     around the requests; forward clips/s per bucket of the ladder, and at
     buckets 64 and 128 (the serve CLI's default ladder, whose largest
     epilogues pass 2^31 elements);
  6. K2 backward against its plain PyTorch version at every epilogue shape
     r2plus1d_18 produces at 16 clips, f32 and bf16, with and without
     residual and ReLU: dx and d_residual (f32 within 2e-6, bf16 within 1
     ulp), the four per-channel gradients within rtol 1e-4 of a float64
     reference, two runs bit-identical; the wrapper's time beside the time
     of its two launches alone (results allocated once) and of the second
     pass alone, and the plain time, summed over one backward pass. The
     forward output that feeds each
     backward is K2 forward at the training path's shapes: it is held
     against its plain version and timed there too, wrapper and launch
     alone, with F.batch_norm as in phase 3 (f32 within 2e-6, bf16 within 1
     ulp; summed over one 16-clip forward);
  6b. the BN statistics' ops (ops/bn_stats.py; they replace no TPU
     kernel: XLA computed these statistics in the JAX package) at every
     train-mode BN of one r2plus1d_18 train step of BN_STATS_CLIPS (64, the
     train cell's) clips, f32 and bf16: the sums within 1e-5 of float64
     sums and bit-equal across two runs, the moments and both gradients bit
     for bit the plain versions'; bf16 times summed over the step: the
     wrappers, the launches alone of the sums and their gradient, the plain
     versions, the bound, the sums alone beside torch.batch_norm_stats (the
     library's one call for per-channel batch statistics, SyncBatchNorm's);
     then tools/check_bn_brackets.py in a process of its own (a traced
     64-clip step: the ops' kernels' device time, the sums' launches, 37 of
     each a step, and the brackets against the kernels); the ops' launches
     on the main paths are counted in phases 7 on (37 of each op and of
     each gradient a train step of r2plus1d_18);
  7. train: the training CLI (cli/main.py) on the synthetic dataset, full
     width r2plus1d_18 + mlp, bf16 compute with float32 masters, batch 16:
     8 steps through the entry point with the kernels' launch counts read
     around them (37 forward and 37 backward epilogues and one K1 launch per
     step, plus one K1 launch and 37 forward epilogues for each dispatch of
     the zero-shot evaluation that ends the epoch, whose forward is timed in
     clips/s at its own batch and at the default 128 clips per dispatch); K1
     on a training batch (16 synthetic-dataset canvases, 1 clip
     each) against its plain version, f32 and bf16, wrapper and launch
     alone timed as in phase 3, and the batch that
     device_batch hands the step against the same; then 8 steps on one
     repeated batch (finite losses, the last below the first, BN running
     statistics moved; step time by CUDA events and by the host's clock,
     clips/s and peak memory after the warm-up steps); two float32 steps on the card
     against the same two on the CPU from the same seeds (loss rtol 1e-4,
     parameters atol 2e-5 from a seeded non-zero Adam state); and one step
     on a NaN batch, which must leave parameters, moments and the step
     count as they were; the epoch through the entry point also writes
     last.npz (--checkpoint_every 1) and, where its accuracy is above 0,
     checkpoint.npz;
 7b. checkpoints: a second Experiment with --resume auto restores exactly
     what last.npz holds (parameters, BN statistics, Adam's moments and
     counters, the step count), goes on at epoch 1 in the run's directory
     and trains it through the kernels (37 / 37 / 1 launches a step, finite
     loss); --evaluate --weights on the best checkpoint gives the saving
     epoch's embeddings of the test table (per-video cosine >= 0.999); and
     the host time a checkpoint write takes from the step loop, written at
     once against handed to the writer thread (train/async_ckpt.py);
  8. K4 (image-motion transform, the same kernel template as K1) against
     its plain PyTorch version at the SUN path's shape (16 images on a
     256x342 canvas, 16 frames each, 112 x 112), f32 (atol 2e-6) and bf16
     (1 ulp), the wrapper's time beside its launch alone (as in phase 3)
     and the plain time, and the antialiased transform's time per batch;
     K4's device time in a torch.profiler trace is taken after phase 10
     (a profiler run makes every later launch cost the host more);
  9. SUN training through cli.main's Experiment at full width: an image
     table of seeded image files (sizes that pass through, get bounded up
     or down and get fitted to the canvas; one file missing) and the
     synthetic dataset's video test table, --bs 32 (16 images a step after
     the halving, 16 clips of 16x112x112), bf16: one epoch with
     --no-sun_antialias (one K4 launch per step) and one with the default
     antialiased transform (no K4 launch), each ending in the zero-shot
     evaluation of the test table (best_accuracy a number); timed steps on
     one repeated batch as in phase 7; and one float32 step of 2 images on
     the card against the same step on the CPU, for both transforms (loss
     rtol 1e-4, parameters atol 2e-5 from a seeded Adam state);
 10. K3 (temporal conv op, which no model calls) against its plain PyTorch
     version at the layer1 shape [16,16,56,56,144] -> 64 and at two ragged
     midplane shapes, f32 (atol/rtol 1e-5) and bf16 (2 ulp beyond the
     float32 bar, which counts where an output cancels to ~0), its gradients
     once against the plain version's, and its time beside the plain
     version's and F.conv3d's (cuDNN) on the same tensors; for each shape
     the kernel and the staging path it took (TMA, cp.async, 2-byte loads)
     and its TFLOP/s against the peak for its type;
 11. C3D through the training CLI at full width (--network c3d --bs 16,
     bf16 over float32 masters, random init): C3D_STEPS steps and the
     evaluation at one K1 launch a step and a dispatch and no K2 (C3D has
     no BN); timed steps and peak memory as in phase 7, the evaluation's
     clips/s; two float32 steps card vs CPU (seeded He weights,
     torch_helpers.calibrate_c3d; dropout at rate 0 on both sides);
 12. C3D served: phase 5's requests to an engine with --network c3d (bf16,
     the same seeded He weights), every top_class the direct f32
     classification's, one K1 launch a dispatch; forward clips/s per bucket;
 13. --network resnet18 (R3D-18 + the linear head, dropout drawn on the
     card) through the training CLI: 20 K2 forward, 20 K2 backward and one
     K1 launch a step; phase 6 at R3D-18's epilogue shapes; timed steps;
 14. --remat full and --remat convs on r2plus1d_18 at 16 clips through the
     training CLI: 72 K2 forward (37 + the 35 of the recomputed blocks), 37
     K2 backward and one K1 a step; timed bf16 steps and peak memory of
     each beside the plain step's; one float32 step of each against the
     plain one from the same init and batch (loss rtol 1e-4, BN running
     statistics moved once);
 15. one --fixconvs step: 37 K2 forward, no K2 backward, one K1; the
     backbone's parameters bit-equal, the head's moved;
 15b. --network x3d_m at its train cell's step, X3D_BS clips of
     16x224x224: phase 6 (K2 forward and backward) and phase 6b (the BN
     statistics' ops) at X3D-M's 84 train-mode BNs (13 shapes; 54 and 108
     channels, no multiple of the 8-lane bf16 vector); cli.main's
     Experiment (bf16 over float32 masters) on one host batch: K1 on it
     against its plain version, the counters reset just before one step
     through device_batch read one K1 launch, 84 of each BN op and
     gradient and 27 of each channel-wise conv kernel (forward, data and
     weight gradient; each held to its plain version and timed at the 27
     convs beside its bound and cuDNN's channels-last call first), the same
     step traced (no cuDNN grouped kernel), then timed steps as in phase 7;
 16. a process group of one under NCCL (r2plus1d_18, 16 clips of
     16x112x112): two float32 steps against the same steps without a group
     (loss rtol 1e-4, parameters atol 2e-5; bit for bit reported), the
     bf16 step timed with and without the group (3 steps after 2), its
     launches (one K1, 37 / 37 a step) and one step's collectives in a
     torch.profiler trace (NCCL kernels, all-reduce calls); before it, K1
     and K2 forward and backward against their plain versions at the
     8-clip shapes of a process of phases 17 and 18;
 17. two spawned processes of 8 clips each (NCCL on cuda:0 and cuda:1 where
     the host shows two GPUs, else gloo with both on cuda:0: NCCL refuses
     two processes on one device): two float32 steps against phase 16's
     one process on the 16 clips (loss rtol 1e-4, parameters atol 2e-5),
     parameters bit-equal across the processes, launches a process one K1
     and 37 / 37 a step, the bf16 step's time (on one GPU a correctness
     figure, not a scaling one);
 18. cli.main on two such processes: one epoch of 2 steps of 16 clips
     with the evaluation and --checkpoint_every 1; both report the same
     metrics, process 1 opens no file to write under the save path, and a
     one-process --evaluate of process 0's checkpoint gives its test
     accuracy;
 19. --steps_per_call as CUDA graphs of the train step (GRAPH_K = 4):
     Experiment.run (what cli.main runs) in float32 at --steps_per_call 4
     against 1 from one seeded Adam state, two epochs of 8 steps (lr 5e-4,
     then 5e-5: a stale rate, class-embedding slot or generator would show)
     and one epoch of 6 (a tail of 2 through the one-step graph): every
     step's loss rtol 1e-4, parameters atol 2e-5, bit-equality reported;
     the bf16 step of 16 clips eager and as a replay / 4, by CUDA events
     and by the host's clock, in one process, peak memory of both and the
     capture's time; K2's kernel nodes in one replay (CUDAGraph.debug_dump:
     37 x 4 forward, 74 x 4 backward; no wrapper is called by a replay); a
     replay of 4 NaN batches leaves parameters, moments and Adam's count
     as they were; --debug_nans raises FloatingPointError naming the step
     of a NaN batch, inside a replayed group and at --steps_per_call 1;
     resnet18's dropout draws new masks each replay and the eager masks
     again once the generator is reseeded; one --remat full group against
     single steps (BN statistics moved once a step, 72 x 4 forward
     kernels); F4's hold: a ballast tensor leaves F4_LEVELS GiB of the
     card free before a float32 group of 16 clips is run eagerly and
     captured, and each level ends in a completed run within the f32 bars
     of single steps or in torch.OutOfMemoryError, never in another error;
     and an NCCL group of one (and of two where the host shows two GPUs)
     with the all-reduces captured, against single steps;
 20. --tp 2, the head's tensor parallelism, on two spawned processes (one
     model group; NCCL on cuda:0 and cuda:1 where the host shows two GPUs,
     else gloo with both on cuda:0): two float32 steps of 16 clips against
     phase 16's one process (loss rtol 1e-4, parameters atol 2e-5 with the
     head's shards made whole), the backbone bit-equal across the
     processes, launches a process one K1 and 37 / 37 a step, 77
     data-group, 3 model-group and 1 whole-group all-reduces a step, the
     bf16 step's time
     (on one GPU a correctness figure, not a scaling one); cli.main at
     --tp 2 (one epoch of 2 steps, the evaluation, a checkpoint with the
     head whole) and a one-process --evaluate of that checkpoint, which
     gives its accuracy;
 21. the serving engine over replicas: over [cuda:0, cuda:0] and, where
     the host shows two or more GPUs, over every GPU (--device cuda),
     against phase 5's one-replica engine on the same weights: float32
     rows within 1e-4, bf16 cosine >= 0.999 per row and the same top
     classes; the ladder rounded up to tile the replicas and data_shards;
     one K1 and 37 K2 forward a replica and dispatch; one POST /classify
     and GET /stats through serve.serve_forever (the main path's
     launches); a reload that swaps every replica; forward clips/s at
     buckets 8-128 beside one replica's; before the engine is closed, K1
     and K2 forward against their plain versions at a replica's shapes on
     the last replica's device (on one card two replicas enqueue on one
     device: a correctness figure, not a scaling one);
 22. the multi-device dry run (dryrun.dryrun_multichip): NCCL over every
     GPU where the host shows two or more, else 2 processes under gloo on
     cuda:0; its loss within rtol 1e-4 of one process's on the same global
     batch; 74 K2 forward and 37 K2 backward launches in process 0; before
     it K2 forward and backward against their plain versions at a
     process's float32 shapes;
 23. one epoch of cli.main --save_samples (2 steps and the evaluation: it
     passes whether the GIF is written or the warning printed, and says
     which); tools/port_checkpoint of a .pth of a seeded port model (its
     state dict, the reference's torchvision key names), loaded by the
     engine as --weights and by reload, float32 embeddings within 1e-4 of
     the seeded model's.

The line before the last is {"kernels": [...]}, one row for each kernel on
each main path that launches it ("path": "serve", "train", "train_sun",
"train_c3d", "serve_c3d", "train_r3d_linear", "train_remat_full",
"train_remat_convs", "train_fixconvs", "train_x3d", "train_dp_world1",
"train_dp_2rank" or "cli_dp_2rank", the last two counted in process 0,
"train_graphs", whose K2 rows also give replay_kernels, the kernel nodes of
one replay of 4 steps, "train_tp_2rank", counted in process 0, "serve_replicas",
"dryrun", counted in process 0, or "cli_save_samples"; "op" for K3,
which is driven through its public op): its launches
in that path's run, and, at that path's shapes, its error against the plain
version, its time, the plain version's, and the least time the card could
take for the same work (bound_ms: bytes at the published 3.35 TB/s against
operations at the published peak for their type; the measured copy
bandwidth is printed beside it), the launch alone (launch_ms: K1, K2
forward and backward, K4; null where not split), K4's device time in a
trace (trace_ms; null for the others), and the time of the one
PyTorch call that computes the same function where there is one
(library_ms; for K2 forward F.batch_norm and for K2 backward aten's
native_batch_norm_backward in eval mode, at the epilogues without residual
and ReLU, with the kernel's launches alone there in library_shapes_ms; for
the BN sums torch.batch_norm_stats, beside the sums alone in sums_ms).
The last is
{"ok": true, "device": {...}}. Without a CUDA device it exits 2 and prints
no result. --json PATH also writes every measurement to PATH. It imports
the port and the helpers in tests/torch_helpers.py (numpy and torch only).
"""

from __future__ import annotations

import argparse
import copy
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request

N_CLIPS, CLIP_LEN, SIZE, MAX_BATCH = 4, 16, 112, 32
N_VIDEOS, FRAMES, HEIGHT, WIDTH = 16, 64, 240, 320
TRAIN_BS, TRAIN_STEPS, TRAIN_WARMUP = 16, 8, 3
CPU_CLIPS = 2  # clips of the float32 steps that also run on the CPU
C3D_STEPS, P8_STEPS = 4, 2  # C3D's epoch; resnet18's and remat's epochs
C3D_SEED = 2  # calibrate_c3d's seed for the f32 steps and the served C3D
REMATS = ("full", "convs")
SUN_BS, SUN_STEPS = 32, 4   # --bs 32 halves to 16 images a step
SUN_CANVAS = (256, 342)
HBM_BYTES_PER_S = 3.35e12   # H100 SXM, published
F32_FLOPS_PER_S = 67e12     # H100 SXM float32 outside the tensor cores
BF16_FLOPS_PER_S = 989e12   # H100 SXM bf16 on the tensor cores, dense
BN_SEED = 1  # BN scale and bias of every model built here
LAUNCH_RUN = 20  # launches between two events when a launch is timed alone
BN_STATS_CLIPS = 64  # the train cell's batch: phase 6b's shapes
X3D_BS, X3D_SIZE = 64, 224  # X3D-M's train cell: phase 15b's step
# bf16 against the CPU f32 forward, per video: the two runs round at
# different places (bf16 conv inputs, outputs and epilogues on one side,
# none on the other, layers.py:71-74 in the JAX package), ~2^-9 relative per
# rounding over 37 layers. On a CPU, with these BN statistics, 16 videos x 4
# clips of 16x112x112 in bf16 stay at cosine >= 0.99998 per video, while an
# epilogue that applies each channel's affine to its neighbour falls to
# 0.53-0.56.
BF16_COSINE_BAR = 0.999
DEVICE = "cuda:0"
RECORD = {}


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def say(*parts):
    print(*parts, flush=True)


_LAP = []


def lap(name):
    """The host's seconds since the previous lap (or the first call) into
    RECORD["phase_seconds"][name]: where main()'s time goes, so that a
    later phase can cut the depth of the ones that cost most."""
    now = time.perf_counter()
    if _LAP:
        RECORD.setdefault("phase_seconds", {})[name] = now - _LAP[-1]
    _LAP.append(now)


def time_ms(fn, reps=10):
    """Median device time of fn() in ms (CUDA events, after one warm-up)."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def run_ms(fn, runs=LAUNCH_RUN, reps=5):
    """Median device time of one fn() in ms, from `runs` calls queued
    between two CUDA events (after one warm-up run): the queue hides the
    host's time of a call while it is shorter than the device's."""
    import torch

    for _ in range(runs):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(runs):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / runs)
    return statistics.median(times)


def bound(out, nbytes, flops, copy_gbs, peak=F32_FLOPS_PER_S):
    """Write into `out` the least ms the card could take for this work
    (bound_ms) and which limit binds (bound_by): bytes over the published
    memory rate against operations over the published peak for their type
    (float32 unless `peak` says otherwise); and the same bytes at the copy
    rate measured in this run (copy_bound_ms)."""
    by, op = nbytes / HBM_BYTES_PER_S * 1e3, flops / peak * 1e3
    out["bound_ms"], out["bound_by"] = ((by, "bytes") if by >= op
                                        else (op, "operations"))
    out["copy_bound_ms"] = nbytes / 1e9 / copy_gbs * 1e3
    return (f"{nbytes / 1e9:.3g} GB -> bound {out['bound_ms']:.3f} ms "
            f"({out['bound_by']}) at the published rate, "
            f"{out['copy_bound_ms']:.3f} ms at the measured copy rate")


def epilogue_bytes_flops(shape, esize, res, relu, backward):
    """Bytes K2 must move for one epilogue (every operand once) and its
    float32 operations."""
    n = math.prod(shape)
    if backward:  # reads x, dy (+ y under relu); writes dx (+ g)
        passes, flops = 3 + int(relu) + int(res), 7 + int(relu)
    else:         # reads x (+ r); writes y
        passes, flops = 2 + int(res), 2 + int(res) + int(relu)
    return n * esize * passes, n * flops


def measure_copy_bandwidth(dev):
    import torch

    src = torch.empty(1 << 30, dtype=torch.uint8, device=dev)
    dst = torch.empty_like(src)
    ms = time_ms(lambda: dst.copy_(src), reps=5)
    gbs = 2 * src.numel() / 1e9 / (ms / 1e3)
    say(f"[env] device copy of 1 GiB: {ms:.3f} ms = {gbs:.0f} GB/s read + "
        f"written (published peak {HBM_BYTES_PER_S / 1e9:.0f} GB/s)")
    RECORD["copy_GB_per_s"] = gbs
    return gbs


def phase_env():
    import torch

    say(f"[env] python {sys.version.split()[0]}  torch {torch.__version__}  "
        f"torch.version.cuda {torch.version.cuda}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0].strip()
    say(smi)
    from zeroshotvideoclassification_tpu_torch import _build

    nvcc = subprocess.run([_build.nvcc_path(), "--version"],
                          capture_output=True, text=True, check=True,
                          timeout=60).stdout.strip().splitlines()[-1]
    try:
        import triton

        tri = f"triton {triton.__version__} imports"
    except ImportError as e:
        tri = f"triton does not import ({e})"
    say(f"[env] nvcc: {nvcc} | {tri} | device 0: "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    RECORD["env"] = {"torch": torch.__version__, "cuda": torch.version.cuda,
                     "nvidia_smi": smi, "nvcc": nvcc, "triton": tri}
    return smi


def phase_build():
    from zeroshotvideoclassification_tpu_torch import _build

    res = _build.build()
    _build.library()
    regs = [ln.strip() for ln in res.log.splitlines()
            if "registers" in ln or "spill" in ln]
    spills = [ln for ln in regs
              if "spill" in ln and " 0 bytes spill" not in ln]
    say(f"[build] {res.path.name} from {len(_build.sources())} sources: "
        f"{res.seconds:.2f} s (compiled={res.compiled}); "
        f"{len(regs)} ptxas lines, spills: {spills or 'none'}")
    RECORD["build"] = {"seconds": res.seconds, "compiled": res.compiled,
                       "ptxas": regs}


def make_videos(tmp):
    import numpy as np

    from torch_helpers import synthetic_clip

    paths = []
    for k in range(N_VIDEOS):
        p = os.path.join(tmp, f"video{k:02d}.npy")
        np.save(p, synthetic_clip(k, FRAMES, HEIGHT, WIDTH))
        paths.append(p)
    return paths


def host_batch(paths, bucket):
    """The serving engine's host half: decode + pack into one batch."""
    import numpy as np

    from zeroshotvideoclassification_tpu_torch.config import Config
    from zeroshotvideoclassification_tpu_torch.data.pipeline import (
        host_batch as pack,
    )

    cfg = Config(size=SIZE, clip_len=CLIP_LEN, n_clips=N_CLIPS)
    return pack(paths, cfg, bucket, ["c"], np.ones((1, 300), np.float32))


def k1_compare(args, dt, what):
    """K1 on `args` (canvas and six taps, on the card) against its plain
    version: checked, timed, and the bytes it must move."""
    import torch

    from torch_helpers import bf16_ulps
    from zeroshotvideoclassification_tpu_torch.ops.resample import (
        fused_video_transform,
    )
    from zeroshotvideoclassification_tpu_torch.ops.resample_cuda import (
        fused_video_transform_cuda,
        transform_plan,
        transform_prepare,
    )

    got = fused_video_transform_cuda(*args, out_dtype=dt)
    torch.cuda.synchronize()
    want = fused_video_transform(*args, out_dtype=dt)
    torch.cuda.synchronize()
    err = float((got.float() - want.float()).abs().max())
    ulps = bf16_ulps(got, want)
    if dt == torch.float32:
        check(err <= 2e-6, f"K1 f32 {what}: {err}")
    else:
        check(ulps <= 1.0, f"K1 bf16 {what}: {ulps} ulp")
    ms = time_ms(lambda: fused_video_transform_cuda(*args, out_dtype=dt))
    launch, _ = transform_prepare(*args, out_dtype=dt)
    launch_ms = run_ms(launch)
    plain = time_ms(lambda: fused_video_transform(*args, out_dtype=dt),
                    reps=5)
    # canvas and taps read once, the output written once; ~12 float32
    # operations per output value (two lerps and the normalisation)
    nbytes = (sum(a.numel() * a.element_size() for a in args)
              + got.numel() * got.element_size())
    b, t, hc, wc, _ = args[0].shape
    plan = transform_plan(b, t, hc, wc, got.shape[2], got.element_size())
    row = {"shape": list(args[0].shape), "dtype": str(dt).split(".")[-1],
           "max_abs_err": err, "bf16_ulps": ulps, "ms": ms,
           "launch_ms": launch_ms, "plain_ms": plain, "bytes": nbytes,
           "flops": 12 * got.numel(), "plan": plan,
           "GB_per_s": nbytes / 1e9 / (launch_ms / 1e3)}
    say(f"[K1] {what} canvas {'x'.join(map(str, row['shape']))} -> "
        f"{row['dtype']}: err {err:.3g} ({ulps:.2f} bf16 ulp)  wrapper "
        f"{ms:.4f} ms, launch alone {launch_ms:.4f} ms "
        f"({row['GB_per_s']:.0f} GB/s; {plan['blocks']} blocks of "
        f"{plan['threads']} threads, a band of {plan['band_rows']} rows "
        f"each, {plan['stage_rows']} rows staged, {plan['smem_bytes']} B "
        f"shared)  plain {plain:.3f} ms")
    return row, want


def phase_k1(paths, dev, copy_gbs, buckets=(8, 32), key="k1",
             what="serve bucket"):
    """K1 against its plain version on `dev` at each bucket's serving batch
    (f32 and bf16, odd samples flipped); the first bucket's bf16 row is
    the record's time and bound. The record goes to RECORD[key]."""
    import torch

    out = {"max_abs_err": 0.0, "shapes": []}
    for bucket in buckets:
        hb = host_batch((paths * 2)[:bucket], bucket)
        args = [torch.from_numpy(a.copy()).to(dev) for a in
                (hb.canvas, hb.y0, hb.y1, hb.wy, hb.x0, hb.x1, hb.wx)]
        for j in (4, 5, 6):  # flip the odd samples: mirrored column taps
            args[j][1::2] = args[j][1::2].flip(1)
        for dt in (torch.float32, torch.bfloat16):
            row, _ = k1_compare(args, dt, f"{what} {bucket}")
            row["bucket"] = bucket
            out["shapes"].append(row)
            out["max_abs_err"] = max(out["max_abs_err"], row["max_abs_err"])
    first = next(r for r in out["shapes"]
                 if r["bucket"] == buckets[0] and r["dtype"] == "bfloat16")
    for k in ("ms", "launch_ms", "plain_ms"):
        out[k] = first[k]
    say(f"[K1] {what} {buckets[0]} -> bfloat16: " + bound(
        out, first["bytes"], first["flops"], copy_gbs))
    RECORD[key] = out
    return out


def epilogue_calls(model, x):
    """(shape [N,T,H,W,C], residual?, relu?) -> count over one forward (of
    `model` in eval mode)."""
    import torch

    from zeroshotvideoclassification_tpu_torch.models.layers import (
        BatchNorm3d,
    )
    from zeroshotvideoclassification_tpu_torch.train import eval_step

    calls = {}

    def hook(mod, args, kwargs):
        s = args[0].shape
        key = ((s[0], *s[2:], s[1]), kwargs.get("residual") is not None,
               bool(kwargs.get("relu", False)))
        calls[key] = calls.get(key, 0) + 1

    hs = [m.register_forward_pre_hook(hook, with_kwargs=True)
          for m in model.modules() if isinstance(m, BatchNorm3d)]
    try:
        eval_step(model, x)
        torch.cuda.synchronize()
    finally:
        for h in hs:
            h.remove()
    return calls


def k2_fwd_times(x, stats, res, relu):
    """K2 forward's wrapper time, its launch alone and the plain version's
    time on these operands, and, without residual and ReLU, F.batch_norm's
    (eval mode, x's channels-last-3d view, the same dtype; a yardstick the
    port never calls) with its distance from the kernel's output. -> dict."""
    import torch
    import torch.nn.functional as F

    from zeroshotvideoclassification_tpu_torch.ops.bn_cuda import (
        bn_apply_relu_cuda,
        bn_apply_relu_plain,
        fwd_plan,
        fwd_prepare,
    )

    out = {"ms": time_ms(lambda: bn_apply_relu_cuda(x, *stats, res, relu)),
           "plain_ms": time_ms(lambda: bn_apply_relu_plain(
               x, *stats, res, relu), reps=5)}
    launch, _ = fwd_prepare(x, *stats, res, relu)
    out["launch_ms"] = run_ms(launch)
    out["plan"] = fwd_plan(x.numel(), x.shape[-1], x.element_size(), True)
    if res is None and not relu:
        scale, bias, mean, var = stats
        xv = x.permute(0, 4, 1, 2, 3)  # NCDHW, channels-last-3d strides

        def lib():
            return F.batch_norm(xv, mean, var, scale, bias, training=False,
                                eps=1e-5)

        try:
            got = lib().permute(0, 2, 3, 4, 1)
            out["library_err"] = float(
                (got.float() - bn_apply_relu_cuda(x, *stats, None, False)
                 .float()).abs().max())
            out["library_ms"] = time_ms(lib)
        except RuntimeError as e:  # a yardstick only: record, go on
            out["library_error"] = str(e).splitlines()[0]
    return out


def add_k2_fwd(out, n, times, shape, esize, res, relu):
    """Add one epilogue's times, `n` calls a forward, to the forward's
    sums in `out` (the library's only where it was timed)."""
    for k in ("ms", "launch_ms", "plain_ms"):
        out[k] += n * times[k]
    by, fl = epilogue_bytes_flops(shape, esize, res, relu, False)
    out["bytes"] += n * by
    out["flops"] += n * fl
    if "library_ms" in times:
        out["library_ms"] = (out.get("library_ms") or 0.0) + n * times[
            "library_ms"]
        out["library_shapes_ms"] += n * times["launch_ms"]
        out["library_max_abs_err"] = max(out["library_max_abs_err"],
                                         times["library_err"])


def k2_fwd_text(out, what, dname="bf16"):
    lib = ("F.batch_norm not timed" if out.get("library_ms") is None else
           f"F.batch_norm {out['library_ms']:.3f} ms at the epilogues "
           f"without residual and ReLU, where the kernel's launches take "
           f"{out['library_shapes_ms']:.3f} ms (outputs within "
           f"{out['library_max_abs_err']:.3g})")
    return (f"per {dname} forward {what}: wrapper {out['ms']:.3f} ms, launches "
            f"alone {out['launch_ms']:.3f} ms, plain {out['plain_ms']:.3f} "
            f"ms; {lib}")


def phase_k2(calls, dev, copy_gbs, key="k2", what="at bucket 8"):
    """K2 forward against its plain version at every epilogue shape of
    `calls` (one bf16 forward's), f32 and bf16, with and without residual
    and ReLU, on `dev`; the bf16 times summed over the forward. The record
    goes to RECORD[key]. -> the record."""
    import torch

    from torch_helpers import bf16_ulps
    from zeroshotvideoclassification_tpu_torch.ops.bn_cuda import (
        bn_apply_relu_cuda,
        bn_apply_relu_plain,
    )

    g = torch.Generator(device=dev).manual_seed(0)
    out = {"max_abs_err": 0.0, "shapes": [], "ms": 0.0, "plain_ms": 0.0,
           "launch_ms": 0.0, "library_ms": None, "library_shapes_ms": 0.0,
           "library_max_abs_err": 0.0, "bytes": 0, "flops": 0}
    shapes = sorted({k[0] for k in calls}, key=lambda s: -math.prod(s))
    for shape in shapes:
        c = shape[-1]
        stats = [torch.rand(c, device=dev, generator=g) * 1.5 + 0.5,
                 torch.randn(c, device=dev, generator=g),
                 torch.randn(c, device=dev, generator=g),
                 torch.rand(c, device=dev, generator=g) * 2.7 + 0.3]
        x32 = torch.randn(shape, device=dev, generator=g)
        r32 = torch.randn(shape, device=dev, generator=g)
        for dt in (torch.float32, torch.bfloat16):
            x, r = x32.to(dt), r32.to(dt)
            for res in (False, True):
                for relu in (False, True):
                    rr = r if res else None
                    got = bn_apply_relu_cuda(x, *stats, rr, relu)
                    torch.cuda.synchronize()
                    want = bn_apply_relu_plain(x, *stats, rr, relu)
                    torch.cuda.synchronize()
                    err = float((got.float() - want.float()).abs().max())
                    ulps = bf16_ulps(got, want)
                    if dt == torch.float32:
                        check(err <= 2e-6, f"K2 f32 {shape} res={res} "
                                           f"relu={relu}: {err}")
                    else:
                        check(ulps <= 1.0, f"K2 bf16 {shape} res={res} "
                                           f"relu={relu}: {ulps} ulp")
                    out["max_abs_err"] = max(out["max_abs_err"], err)
                    n = calls.get((shape, res, relu), 0)
                    if not n:
                        continue
                    t = k2_fwd_times(x, stats, rr, relu)
                    gb = x.numel() * x.element_size() * (3 if res else 2) / 1e9
                    row = {"shape": list(shape), "dtype": str(dt)[6:],
                           "residual": res, "relu": relu, "calls": n,
                           "max_abs_err": err, "bf16_ulps": ulps, **t,
                           "GB_per_s": gb / (t["launch_ms"] / 1e3)}
                    out["shapes"].append(row)
                    if dt == torch.bfloat16:
                        add_k2_fwd(out, n, t, shape, 2, res, relu)
                    lib = ("" if "library_ms" not in t else
                           f"  F.batch_norm {t['library_ms']:.4f} ms")
                    say(f"[K2] {'x'.join(map(str, shape))} {row['dtype']} "
                        f"res={int(res)} relu={int(relu)} x{n}: err "
                        f"{err:.3g} ({ulps:.2f} ulp)  wrapper {t['ms']:.4f} "
                        f"ms, launch alone {t['launch_ms']:.4f} ms "
                        f"({row['GB_per_s']:.0f} GB/s; {t['plan']['path']}, "
                        f"{t['plan']['col_tiles'] * t['plan']['chunks']} "
                        f"blocks of {t['plan']['threads']})  plain "
                        f"{t['plain_ms']:.3f} ms" + lib)
        del x32, r32, x, r
    say(f"[K2] all {len(shapes)} shapes x 8 variants agree; "
        + k2_fwd_text(out, f"{what} over {sum(calls.values())} "
                           f"epilogues") + "; "
        + bound(out, out["bytes"], out["flops"], copy_gbs))
    RECORD[key] = out
    return out


def k2_bwd_library(x, dy, stats, dx):
    """aten's native_batch_norm_backward in eval mode (the statistics
    given, no gradient through them) on the channels-last-3d views: the
    same dx, d_scale and d_bias as K2 backward where the epilogue has
    neither residual nor ReLU; a yardstick the port never calls. -> its
    time and its dx's distance from the kernel's, or the error it raised."""
    import torch

    scale, mean, var = stats
    xv, dyv = x.permute(0, 4, 1, 2, 3), dy.permute(0, 4, 1, 2, 3)
    invstd = torch.rsqrt(var + 1e-5)  # CUDA's asks for the saved pair too

    def lib():
        return torch.ops.aten.native_batch_norm_backward(
            dyv, xv, scale, mean, var, mean, invstd, False, 1e-5,
            [True, True, True])

    try:
        got = lib()[0].permute(0, 2, 3, 4, 1)
        return {"library_err": float((got.float() - dx.float()).abs().max()),
                "library_ms": time_ms(lib)}
    except RuntimeError as e:  # a yardstick only: record, go on
        return {"library_error": str(e).splitlines()[0]}


def phase_k2_bwd(calls, dev, copy_gbs, key="", clips=TRAIN_BS,
                 dtype=None):
    """K2 backward, and the K2 forward that feeds it, at every epilogue
    shape of one train step of `clips` clips (of r2plus1d_18 unless the
    epilogue `calls` are another model's; `key` names that model or batch
    in the record and the lines), both dtypes checked and `dtype`'s
    (bf16 unless given) times summed over the step. Beside K2 backward at
    the epilogues without residual and ReLU, k2_bwd_library. ->
    (backward's record, forward's)."""
    import torch

    dtype = dtype or torch.bfloat16
    dname = str(dtype)[6:]

    from torch_helpers import bf16_ulps
    from zeroshotvideoclassification_tpu_torch.ops.bn_cuda import (
        bn_apply_relu_bwd_cuda,
        bn_apply_relu_bwd_plain,
        bn_apply_relu_cuda,
        bn_apply_relu_plain,
        bwd_plan,
        bwd_prepare,
    )

    names = ("dx", "d_scale", "d_bias", "d_mean", "d_var", "d_res")
    g = torch.Generator(device=dev).manual_seed(1)
    out = {"max_abs_err": 0.0, "sum_max_rel_err": 0.0, "shapes": [],
           "ms": 0.0, "plain_ms": 0.0, "bytes": 0, "flops": 0,
           "launches_ms": 0.0, "pass2_ms": 0.0, "library_ms": None,
           "library_shapes_ms": 0.0, "library_max_abs_err": 0.0}
    fwd = {"max_abs_err": 0.0, "shapes": [], "ms": 0.0, "plain_ms": 0.0,
           "launch_ms": 0.0, "library_ms": None, "library_shapes_ms": 0.0,
           "library_max_abs_err": 0.0, "bytes": 0, "flops": 0}
    shapes = sorted({k[0] for k in calls}, key=lambda s: -math.prod(s))
    for shape in shapes:
        c = shape[-1]
        scale = torch.rand(c, device=dev, generator=g) * 1.5 + 0.5
        bias = torch.randn(c, device=dev, generator=g)
        mean = torch.randn(c, device=dev, generator=g)
        var = torch.rand(c, device=dev, generator=g) * 2.7 + 0.3
        x32 = torch.randn(shape, device=dev, generator=g)
        r32 = torch.randn(shape, device=dev, generator=g)
        dy32 = torch.randn(shape, device=dev, generator=g)
        dims = tuple(range(len(shape) - 1))
        for dt in (torch.float32, torch.bfloat16):
            x, r, dy = x32.to(dt), r32.to(dt), dy32.to(dt)
            for res in (False, True):
                for relu in (False, True):
                    f_args = (x, scale, bias, mean, var, r if res else None,
                              relu)
                    y = bn_apply_relu_cuda(*f_args)
                    torch.cuda.synchronize()
                    y_plain = bn_apply_relu_plain(*f_args)
                    what = f"K2 fwd {shape} {dt} res={res} relu={relu}"
                    f_err = float((y.float() - y_plain.float()).abs().max())
                    f_ulps = bf16_ulps(y, y_plain)
                    if dt == torch.float32:
                        check(f_err <= 2e-6, f"{what}: {f_err}")
                    else:
                        check(f_ulps <= 1.0, f"{what}: {f_ulps} ulp")
                    fwd["max_abs_err"] = max(fwd["max_abs_err"], f_err)
                    del y_plain
                    args = (x, y, dy, scale, mean, var, relu, res)
                    got = bn_apply_relu_bwd_cuda(*args)
                    again = bn_apply_relu_bwd_cuda(*args)
                    torch.cuda.synchronize()
                    want = bn_apply_relu_bwd_plain(*args)
                    what = f"K2 bwd {shape} {dt} res={res} relu={relu}"
                    for nm, a, b in zip(names, got, again):
                        check((a is None and b is None) or torch.equal(a, b),
                              f"{what}: {nm} differs between two runs")
                    err = 0.0
                    for i in (0, 5):  # dx, d_res against the plain version
                        if want[i] is None:
                            check(got[i] is None, f"{what}: {names[i]}")
                            continue
                        e = float((got[i].float() - want[i].float())
                                  .abs().max())
                        err = max(err, e)
                        if dt == torch.float32:
                            check(e <= 2e-6, f"{what} {names[i]}: {e}")
                        else:
                            u = bf16_ulps(got[i], want[i])
                            check(u <= 1.0, f"{what} {names[i]}: {u} ulp")
                    # the per-channel gradients against float64 sums
                    sinv = torch.rsqrt(var.double() + 1e-5)
                    a64 = scale.double() * sinv
                    g64 = dy.double()
                    if relu:
                        g64 = g64 * (y > 0)
                    s1 = g64.sum(dims)
                    g64 *= x.double() * sinv - mean.double() * sinv
                    s2 = g64.sum(dims)
                    del g64
                    ref = (s2, s1, -a64 * s1,
                           -0.5 * scale.double() * sinv * sinv * s2)
                    rel = 0.0
                    for nm, a, b in zip(names[1:5], got[1:5], ref):
                        tol = 1e-4 * b.abs() + 1e-4 * float(b.abs().max())
                        d = (a.double() - b).abs()
                        check(bool((d <= tol).all()),
                              f"{what} {nm}: off by {float(d.max())}")
                        rel = max(rel, float((d / float(b.abs().max()))
                                             .max()))
                    out["max_abs_err"] = max(out["max_abs_err"], err)
                    out["sum_max_rel_err"] = max(out["sum_max_rel_err"], rel)
                    n = calls.get((shape, res, relu), 0)
                    if not n:
                        continue
                    ft = k2_fwd_times(x, [scale, bias, mean, var],
                                      r if res else None, relu)
                    f_by, _ = epilogue_bytes_flops(
                        shape, x.element_size(), res, relu, False)
                    fwd["shapes"].append({
                        "shape": list(shape), "dtype": str(dt)[6:],
                        "residual": res, "relu": relu, "calls": n,
                        "max_abs_err": f_err, "bf16_ulps": f_ulps, **ft,
                        "GB_per_s": f_by / 1e9 / (ft["launch_ms"] / 1e3)})
                    ms = time_ms(lambda: bn_apply_relu_bwd_cuda(*args))
                    plain = time_ms(lambda: bn_apply_relu_bwd_plain(*args),
                                    reps=3)
                    # the two launches alone, on results allocated once (8
                    # calls per pair of events, so that the queue hides the
                    # host), and the second pass alone
                    launch, _ = bwd_prepare(*args)
                    dev_ms = time_ms(
                        lambda: [launch() for _ in range(8)]) / 8
                    p2_ms = time_ms(
                        lambda: [launch(2) for _ in range(8)]) / 8
                    plan = bwd_plan(x.numel(), c, x.element_size(), True)
                    by, fl = epilogue_bytes_flops(shape, x.element_size(),
                                                  res, relu, True)
                    lib = ({} if res or relu else k2_bwd_library(
                        x, dy, (scale, mean, var), got[0]))
                    row = {"shape": list(shape), "dtype": str(dt)[6:],
                           "residual": res, "relu": relu, "calls": n,
                           "max_abs_err": err, "sum_rel_err": rel, "ms": ms,
                           "plain_ms": plain, "launches_ms": dev_ms,
                           "pass2_ms": p2_ms, "plan": plan,
                           "GB_per_s": by / 1e9 / (dev_ms / 1e3), **lib}
                    out["shapes"].append(row)
                    if dt == dtype:
                        out["ms"] += n * ms
                        out["plain_ms"] += n * plain
                        out["launches_ms"] += n * dev_ms
                        out["pass2_ms"] += n * p2_ms
                        out["bytes"] += n * by
                        out["flops"] += n * fl
                        if "library_ms" in lib:
                            out["library_ms"] = ((out["library_ms"] or 0.0)
                                                 + n * lib["library_ms"])
                            out["library_shapes_ms"] += n * dev_ms
                            out["library_max_abs_err"] = max(
                                out["library_max_abs_err"],
                                lib["library_err"])
                        add_k2_fwd(fwd, n, ft, shape, x.element_size(), res,
                                   relu)
                    say(f"[K2 fwd, train{key}] {'x'.join(map(str, shape))} "
                        f"{str(dt)[6:]} res={int(res)} relu={int(relu)} "
                        f"x{n}: err {f_err:.3g} ({f_ulps:.2f} ulp)  wrapper "
                        f"{ft['ms']:.4f} ms, launch alone "
                        f"{ft['launch_ms']:.4f} ms  plain "
                        f"{ft['plain_ms']:.3f} ms"
                        + ("" if "library_ms" not in ft else
                           f"  F.batch_norm {ft['library_ms']:.4f} ms"))
                    say(f"[K2 bwd{key}] {'x'.join(map(str, shape))} "
                        f"{row['dtype']} res={int(res)} relu={int(relu)} "
                        f"x{n}: dx err {err:.3g}, sums rel {rel:.2g}  wrapper "
                        f"{ms:.3f} ms, launches alone {dev_ms:.4f} ms "
                        f"({row['GB_per_s']:.0f} GB/s; {plan['path']}, "
                        f"{plan['col_tiles'] * plan['chunks']} blocks of "
                        f"{plan['threads']}), pass 2 alone {p2_ms * 1e3:.1f} "
                        f"us  plain {plain:.3f} ms"
                        + ("" if "library_ms" not in lib else
                           f"  native_batch_norm_backward "
                           f"{lib['library_ms']:.4f} ms"))
            del x, r, dy, y, got, again, want
        del x32, r32, dy32
    lib = ("native_batch_norm_backward not timed"
           if out["library_ms"] is None else
           f"native_batch_norm_backward {out['library_ms']:.3f} ms at the "
           f"epilogues without residual and ReLU, where the kernel's "
           f"launches take {out['library_shapes_ms']:.3f} ms (dx within "
           f"{out['library_max_abs_err']:.3g})")
    say(f"[K2 bwd{key}] all {len(shapes)} shapes x 8 variants agree and "
        f"repeat bit for bit; per {dname} backward pass at {clips} clips: "
        f"wrapper {out['ms']:.3f} ms, the launches alone "
        f"{out['launches_ms']:.3f} ms of which pass 2 {out['pass2_ms']:.3f} "
        f"ms, plain {out['plain_ms']:.3f} ms over {sum(calls.values())} "
        f"epilogues; {lib}; "
        + bound(out, out["bytes"], out["flops"], copy_gbs))
    say(f"[K2 fwd, train{key}] the same shapes and variants agree; "
        + k2_fwd_text(fwd, f"at {clips} clips over "
                           f"{sum(calls.values())} epilogues",
                      dname) + "; "
        + bound(fwd, fwd["bytes"], fwd["flops"], copy_gbs))
    RECORD["k2_bwd" + key], RECORD["k2_fwd_train" + key] = out, fwd
    return out, fwd


def phase_bn_stats(calls, dev, copy_gbs, clips=BN_STATS_CLIPS, key=""):
    """6b: the BN statistics' ops at every train-mode BN of one train step
    of `clips` clips (the shapes of phase 6's `calls`, widened), checked in
    f32 and bf16 and timed in bf16; then, for r2plus1d_18 (no `key`), the
    traced step of tools/check_bn_brackets.py in a process of its own.
    `key` names another model in the record and the lines. -> the
    record."""
    import torch

    from torch_helpers import bn_sums_ref64
    from zeroshotvideoclassification_tpu_torch.ops.bn_stats import (
        bn_moments_cuda,
        bn_moments_grad_cuda,
        bn_moments_grad_plain,
        bn_moments_plain,
        bn_sums_cuda,
        bn_sums_grad_cuda,
        bn_sums_grad_plain,
        bn_sums_plain,
        grad_prepare,
        sums_prepare,
    )

    per_shape = {}
    for (shape, _, _), n in calls.items():
        wide = (clips, *shape[1:])
        per_shape[wide] = per_shape.get(wide, 0) + n
    out = {"clips": clips, "shapes": [], "ms": 0.0, "launch_ms": 0.0,
           "plain_ms": 0.0, "sums_ms": 0.0, "library_ms": 0.0, "bytes": 0,
           "flops": 0, "max_abs_err": 0.0, "sums_max_rel_err": 0.0}
    g = torch.Generator(device=dev).manual_seed(2)
    for shape, n in sorted(per_shape.items(), key=lambda kv: -math.prod(
            kv[0])):
        c = shape[-1]
        centre = torch.randn(c, device=dev, generator=g) * 3
        m0 = centre + 0.1 * torch.randn(c, device=dev, generator=g)
        rv = torch.rand(c, device=dev, generator=g) + 0.5
        dsums = torch.randn(2, c, device=dev, generator=g)
        dmean, dvar = torch.randn(2, c, device=dev, generator=g)
        x32 = torch.randn(shape, device=dev, generator=g).add_(centre)
        rows = torch.full((1,), float(math.prod(shape[:-1])), device=dev)
        for dt in (torch.float32, torch.bfloat16):
            x = x32.to(dt)
            what = f"BN stats {shape} {str(dt)[6:]}"
            sums = bn_sums_cuda(x, m0)
            again = bn_sums_cuda(x, m0)
            dx = bn_sums_grad_cuda(x, m0, dsums)
            mom = bn_moments_cuda(sums[:2], rows, m0, rv, 0.1)
            dmom = bn_moments_grad_cuda(dmean, dvar, mom[4:], rows)
            torch.cuda.synchronize()
            check(torch.equal(sums, again), f"{what}: two runs differ")
            ref = bn_sums_ref64(x, m0)
            rel = max(float(((sums[k].double() - ref[k]).abs()
                             / ref[2 if k == 0 else 1]).max())
                      for k in (0, 1))
            check(rel <= 1e-5 and torch.equal(sums[2], m0),
                  f"{what}: sums off float64 by {rel:.3g}")
            check(torch.equal(dx, bn_sums_grad_plain(x, m0, dsums)),
                  f"{what}: the gradient is not the plain version's")
            check(torch.equal(mom, bn_moments_plain(sums[:2], rows, m0, rv,
                                                    0.1))
                  and torch.equal(dmom, bn_moments_grad_plain(
                      dmean, dvar, mom[4:], rows)),
                  f"{what}: the moments are not the plain version's")
            out["sums_max_rel_err"] = max(out["sums_max_rel_err"], rel)
            if dt != torch.bfloat16:
                continue

            def wrappers():
                bn_sums_cuda(x, m0)
                bn_moments_cuda(sums[:2], rows, m0, rv, 0.1)
                bn_moments_grad_cuda(dmean, dvar, mom[4:], rows)
                bn_sums_grad_cuda(x, m0, dsums)

            def plain():
                s = bn_sums_plain(x, m0)
                mp = bn_moments_plain(s[:2], rows, m0, rv, 0.1)
                bn_moments_grad_plain(dmean, dvar, mp[4:], rows)
                bn_sums_grad_plain(x, m0, dsums)

            rows2d = x.view(-1, c)  # channels innermost: the library's
            # channels-last path, one read of x for mean and invstd
            launch_s, _ = sums_prepare(x, m0)
            launch_g, _ = grad_prepare(x, m0, dsums)
            t = {"ms": time_ms(wrappers), "plain_ms": time_ms(plain, reps=3),
                 "launch_ms": run_ms(lambda: (launch_s(), launch_g())),
                 "sums_ms": time_ms(lambda: bn_sums_cuda(x, m0)),
                 "library_ms": time_ms(
                     lambda: torch.batch_norm_stats(rows2d, 1e-5))}
            # the sums read x, the gradient reads x and writes dx; float32
            # operations: 4 an element for the sums, 3 for the gradient
            by, fl = 3 * x.numel() * x.element_size(), 7 * x.numel()
            for k in ("ms", "plain_ms", "launch_ms", "sums_ms",
                      "library_ms"):
                out[k] += n * t[k]
            out["bytes"] += n * by
            out["flops"] += n * fl
            out["shapes"].append({"shape": list(shape), "calls": n,
                                  "sums_rel_err": rel, **t,
                                  "GB_per_s": by / 1e9 / (
                                      t["launch_ms"] / 1e3)})
            say(f"[BN stats{key}] {'x'.join(map(str, shape))} bf16 x{n}: "
                f"sums within {rel:.2g} of float64, the rest bit for bit; "
                f"wrappers {t['ms']:.4f} ms, sums + gradient launches "
                f"alone {t['launch_ms']:.4f} ms "
                f"({by / 1e9 / (t['launch_ms'] / 1e3):.0f} GB/s), plain "
                f"{t['plain_ms']:.3f} ms; the sums alone "
                f"{t['sums_ms']:.4f} ms, torch.batch_norm_stats "
                f"{t['library_ms']:.4f} ms")
            del launch_s, launch_g, rows2d
        del x32, x, sums, again, dx, mom, dmom
    text = bound(out, out["bytes"], out["flops"], copy_gbs)
    say(f"[BN stats{key}] per bf16 train step at {clips} clips over "
        f"{sum(per_shape.values())} BNs: wrappers {out['ms']:.3f} ms, "
        f"launches alone {out['launch_ms']:.3f} ms, plain "
        f"{out['plain_ms']:.3f} ms; the sums alone {out['sums_ms']:.3f} ms "
        f"against torch.batch_norm_stats {out['library_ms']:.3f} ms; "
        + text)
    torch.cuda.empty_cache()
    if key:
        RECORD["bn_stats" + key] = out
        return out
    path = os.path.join(tempfile.mkdtemp(prefix="bn_brackets_"), "out.json")
    root = os.path.dirname(os.path.abspath(__file__))
    proc = subprocess.run(
        [sys.executable, os.path.join(root, "tools", "check_bn_brackets.py"),
         "--clips", str(clips), "--steps", "3", "--json", path],
        cwd=root, capture_output=True, text=True, timeout=600)
    check(proc.returncode == 0, f"check_bn_brackets: {proc.stderr[-2000:]}")
    with open(path) as f:
        traced = json.load(f)
    say(f"[BN stats] a traced {clips}-clip step: {json.dumps(traced)}")
    check(all(traced[k] == 37 for k in ("sums_ops", "sums_nodes",
                                        "sums_launches",
                                        "sums_grad_launches")),
          f"BN stats: not every train-mode BN took the op: {traced}")
    out["trace_ms"] = (traced["sums_kernels_fwd_ms"]
                       + traced["sums_kernels_bwd_ms"])
    out["traced"] = traced
    RECORD["bn_stats"] = out
    return out


def kernel_counts():
    from zeroshotvideoclassification_tpu_torch.ops.bn_cuda import (
        bn_apply_relu_bwd_cuda,
        bn_apply_relu_cuda,
    )
    from zeroshotvideoclassification_tpu_torch.ops.bn_stats import (
        bn_moments_cuda,
        bn_moments_grad_cuda,
        bn_sums_cuda,
        bn_sums_grad_cuda,
    )
    from zeroshotvideoclassification_tpu_torch.ops.resample_cuda import (
        fused_image_motion_transform_cuda,
        fused_video_transform_cuda,
    )
    from zeroshotvideoclassification_tpu_torch.ops.temporal_conv import (
        temporal_conv3_cuda,
    )
    from zeroshotvideoclassification_tpu_torch.ops.channelwise_conv import (
        channelwise_dgrad_cuda,
        channelwise_fwd_cuda,
        channelwise_wgrad_cuda,
    )

    return {"video_transform": fused_video_transform_cuda,
            "bn_apply_relu": bn_apply_relu_cuda,
            "bn_apply_relu_bwd": bn_apply_relu_bwd_cuda,
            "bn_sums": bn_sums_cuda, "bn_sums_grad": bn_sums_grad_cuda,
            "bn_moments": bn_moments_cuda,
            "bn_moments_grad": bn_moments_grad_cuda,
            "image_motion_transform": fused_image_motion_transform_cuda,
            "temporal_conv3": temporal_conv3_cuda,
            "channelwise_fwd": channelwise_fwd_cuda,
            "channelwise_dgrad": channelwise_dgrad_cuda,
            "channelwise_wgrad": channelwise_wgrad_cuda}


def zero_counts():
    for fn in kernel_counts().values():
        fn.launches = 0


def read_counts():
    return {k: fn.launches for k, fn in kernel_counts().items()}


def bn_running(model):
    import torch

    return torch.cat([b.flatten() for n, b in model.named_buffers()
                      if n.endswith(("running_mean", "running_var"))])


def timed_steps(exp, batch, class_embed, smi, tag, clips=TRAIN_BS,
                size=SIZE):
    """TRAIN_STEPS steps of `exp`'s train step on one repeated batch of
    `clips` clips of CLIP_LEN x `size` x `size`: every step timed by CUDA
    events and by the host's clock around a synchronise, then the timed
    ones again queued back to back; finite falling losses, moved BN
    statistics (where the model has BN), float32 masters. -> the
    measurements."""
    import torch

    has_bn = any(n.endswith("running_mean") for n, _ in
                 exp.model.named_buffers())
    stats0 = bn_running(exp.model).clone() if has_bn else None

    def one_step():
        return exp.train_step(batch["x"], batch["z"], batch["label"],
                              batch["weight"], class_embed)

    def events():
        return (torch.cuda.Event(enable_timing=True),
                torch.cuda.Event(enable_timing=True))

    losses, times, ev_times = [], [], []
    for i in range(TRAIN_STEPS):
        if i == TRAIN_WARMUP:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        a, b = events()
        t0 = time.perf_counter()
        a.record()
        m = one_step()
        b.record()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        ev_times.append(a.elapsed_time(b))
        losses.append(float(m["loss"]))
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    step_ms = statistics.median(times[TRAIN_WARMUP:])
    event_ms = statistics.median(ev_times[TRAIN_WARMUP:])
    # the same steps queued without a synchronisation in between
    n_queued = TRAIN_STEPS - TRAIN_WARMUP
    a, b = events()
    t0 = time.perf_counter()
    a.record()
    for _ in range(n_queued):
        m = one_step()
    b.record()
    torch.cuda.synchronize()
    queued_ms = (time.perf_counter() - t0) * 1e3 / n_queued
    queued_event_ms = a.elapsed_time(b) / n_queued
    losses.append(float(m["loss"]))
    say(f"[{tag}] repeated batch of {clips} x {CLIP_LEN}x{size}x{size} "
        f"bf16: losses {[round(v, 5) for v in losses]}")
    say(f"[{tag}] step {event_ms:.2f} ms by CUDA events = "
        f"{clips / event_ms * 1e3:.1f} clips/s, {step_ms:.1f} ms by the "
        f"host's clock = {clips / step_ms * 1e3:.1f} clips/s (medians of "
        f"{n_queued} synchronised steps after {TRAIN_WARMUP} warm-up steps; "
        f"first step {times[0]:.0f} ms); queued back to back "
        f"{queued_event_ms:.2f} ms by events, {queued_ms:.1f} ms by the "
        f"host's clock = {clips / queued_ms * 1e3:.1f} clips/s; peak "
        f"memory {peak:.2f} GiB  ({smi})")
    say(f"[{tag}] every step, ms by events: "
        f"{[round(v, 2) for v in ev_times]}; by the host's clock: "
        f"{[round(v, 2) for v in times]}")
    check(all(math.isfinite(v) for v in losses), f"losses {losses}")
    check(losses[-1] < losses[0], f"loss did not fall: {losses}")
    if has_bn:
        moved = float((bn_running(exp.model) - stats0).abs().max())
        check(moved > 1e-3, f"BN running statistics moved by {moved}")
    check(int(exp.optimizer.total_notfinite) == 0, "a finite step skipped")
    for p in exp.model.parameters():
        check(p.dtype == torch.float32 and p.grad.dtype == torch.float32,
              "masters and gradients must be float32")
    return {
        "losses": losses, "step_ms": step_ms, "step_ms_all": times,
        "queued_step_ms": queued_ms, "step_event_ms": event_ms,
        "step_event_ms_all": ev_times,
        "queued_step_event_ms": queued_event_ms,
        "event_clips_per_s": clips / event_ms * 1e3,
        "clips_per_s": clips / step_ms * 1e3,
        "queued_clips_per_s": clips / queued_ms * 1e3, "peak_GiB": peak}


def eval_forward_rate(exp, clips_per_dispatch, smi, tag):
    """clips/s of the evaluation's forward (eval-mode BN, the trainer's
    float32 masters cast per call) at each dispatch size, input already on
    the card. -> {clips: {"ms", "clips_per_s"}}."""
    import torch

    from zeroshotvideoclassification_tpu_torch.train import eval_step

    exp.model.eval()
    out = {}
    for clips in clips_per_dispatch:
        x = torch.rand((clips, 1, CLIP_LEN, SIZE, SIZE, 3), device=exp.device,
                       dtype=torch.float32).sub_(0.5).to(exp.dtype)
        ms = time_ms(lambda: eval_step(exp.model, x), reps=5)
        out[clips] = {"ms": ms, "clips_per_s": clips / (ms / 1e3)}
        say(f"[{tag}] evaluation forward, {clips} clips per dispatch, "
            f"{str(exp.dtype)[6:]}: {ms:.2f} ms = "
            f"{out[clips]['clips_per_s']:.1f} clips/s  ({smi})")
        del x
    return out


def cli_argv(tmp, dev, dtype, bs, samples, *flags, network="r2plus1d_18"):
    """The training CLI's arguments for one epoch of `samples` synthetic
    clips at batch `bs`."""
    return ["--dataset", "synthetic", "--network", network,
            "--bs", str(bs), "--train_samples", str(samples),
            "--n_epochs", "1", "--compute_dtype", dtype, "--save_path",
            os.path.join(tmp, "runs"), "--no-progressbar",
            "--nopretrained", "--device", str(dev), *flags]


def train_argv(tmp, dev, dtype, bs, samples):
    """The training CLI's arguments of phase 7 (one epoch, a last.npz and,
    where the epoch's accuracy is above 0, a checkpoint.npz)."""
    return cli_argv(tmp, dev, dtype, bs, samples, "--checkpoint_every", "1")


def f32_card_vs_cpu(args32, dev, tag, first, prepare=None):
    """Two float32 steps of CPU_CLIPS clips of the synthetic dataset of the
    training CLI's arguments `args32`, on the CPU and on the card, from the
    same seeds and a seeded non-zero Adam state (`prepare(model)` first, on
    both sides): loss rtol 1e-4, parameters atol 2e-5, and the parameter
    `first` moved by more than the bar. -> (the record, the card's
    Experiment, its batch, its class embeddings)."""
    import numpy as np
    import torch

    from torch_helpers import seed_adam
    from zeroshotvideoclassification_tpu_torch.cli import main as train_cli
    from zeroshotvideoclassification_tpu_torch.config import (
        config_from_namespace,
    )
    from zeroshotvideoclassification_tpu_torch.data.datasets import (
        build_datasets,
    )
    from zeroshotvideoclassification_tpu_torch.data.pipeline import (
        HostPipeline,
        device_batch,
    )

    cfg32 = config_from_namespace(
        train_cli.build_arg_parser().parse_args(args32))
    data32 = build_datasets(cfg32, None)
    table = data32["training"][0]
    host = next(iter(HostPipeline(table, cfg32, CPU_CLIPS, seed=cfg32.seed)))
    ce_np = np.asarray(table.class_embed, np.float32)
    runs = {}
    for d in ("cpu", dev):
        exp = train_cli.Experiment(cfg32, data32, device=d)
        if prepare is not None:
            prepare(exp.model)
        seed_adam(exp.optimizer, exp.model, seed=3, count=1000)
        w0 = exp.model.state_dict()[first].detach().cpu().clone()
        b = device_batch(host, table.n_clips, cfg32.clip_len,
                         torch.float32, d)
        ce = torch.from_numpy(ce_np).to(d)
        t0 = time.perf_counter()
        ls = [float(exp.train_step(b["x"], b["z"], b["label"], b["weight"],
                                   ce)["loss"]) for _ in range(2)]
        runs[str(d)] = (ls, {k: v.detach().cpu().clone() for k, v in
                             exp.model.named_parameters()},
                        time.perf_counter() - t0)
        exp.log.close()
        if d == "cpu":
            del exp, b
    (l_cpu, p_cpu, s_cpu), (l_gpu, p_gpu, _) = runs["cpu"], runs[str(dev)]
    rel = max(abs(a - b) / abs(b) for a, b in zip(l_gpu, l_cpu))
    dmax = max(float((p_gpu[k] - p_cpu[k]).abs().max()) for k in p_cpu)
    moved = float((p_gpu[first] - w0).abs().max())
    say(f"[{tag}] 2 float32 steps of {CPU_CLIPS} clips, card vs CPU "
        f"(CPU {s_cpu:.1f} s): losses {l_gpu} vs {l_cpu} (rel {rel:.2g}, "
        f"bar 1e-4); parameters differ by at most {dmax:.3g} (bar 2e-5) "
        f"after moving by up to {moved:.3g}")
    check(rel <= 1e-4, f"{tag}: loss card vs CPU: {l_gpu} vs {l_cpu}")
    check(dmax <= 2e-5, f"{tag}: parameters card vs CPU: {dmax}")
    check(moved > 1e-4, f"{tag}: the two steps moved {first} by {moved}")
    return ({"loss_rel": rel, "param_max_abs": dmax, "cpu_seconds": s_cpu},
            exp, b, ce)


def phase_train(tmp, dev, smi, copy_gbs):
    """The training CLI's path at full width, then K1 on a training batch,
    timed steps, the float32 steps against the CPU, and the NaN step.
    -> (the entry point's launches, K1's record at the training shape)."""
    import numpy as np
    import torch

    from torch_helpers import bf16_ulps
    from zeroshotvideoclassification_tpu_torch.ops.bn_cuda import (
        bn_apply_relu_bwd_cuda,
    )

    def argv(dtype, bs, samples):
        return train_argv(tmp, dev, dtype, bs, samples)

    # (a) the entry point: one epoch of TRAIN_STEPS batches of TRAIN_BS
    args = argv("bfloat16", TRAIN_BS, TRAIN_BS * TRAIN_STEPS)
    bn_apply_relu_bwd_cuda.dy_copies = 0
    summary, launches, wall = cli_epoch(args, "train", expect(
        TRAIN_STEPS + 1, 37 * (TRAIN_STEPS + 1), 37 * TRAIN_STEPS))
    copies = bn_apply_relu_bwd_cuda.dy_copies
    say(f"[train] {TRAIN_STEPS} steps; best accuracy "
        f"{summary['best_accuracy']:.1f}, dy copies {copies}")
    check(summary["best_accuracy"] == summary["synthetic_test_accuracy"],
          f"cli.main accuracy {summary}")

    # (b) steps on one repeated batch, the same objects the CLI builds
    exp, host, class_embed = experiment(args, dev)
    batch = to_card(exp, host)
    check(tuple(batch["x"].shape) == (TRAIN_BS, 1, CLIP_LEN, SIZE, SIZE, 3)
          and batch["x"].dtype == torch.bfloat16, "train batch shape")
    # K1 at the training shape: the pipeline's own canvases and taps (random
    # crops and flips), and the batch device_batch gave the step
    k1_args = [torch.from_numpy(np.ascontiguousarray(getattr(host, k)))
               .to(dev)
               for k in ("canvas", "y0", "y1", "wy", "x0", "x1", "wx")]
    k1 = {"shapes": []}
    for dt in (torch.float32, torch.bfloat16):
        row, want = k1_compare(k1_args, dt, f"train batch of {TRAIN_BS}")
        k1["shapes"].append(row)
    ulps = bf16_ulps(batch["x"].reshape(want.shape), want)
    check(ulps <= 1.0, f"device_batch's bf16 clips are {ulps} ulp from the "
                       f"plain transform of the same host batch")
    k1["max_abs_err"] = max(r["max_abs_err"] for r in k1["shapes"])
    for k in ("ms", "launch_ms", "plain_ms"):
        k1[k] = row[k]
    say(f"[K1] train batch of {TRAIN_BS} -> bfloat16 (device_batch's output "
        f"within {ulps:.2f} ulp of the plain transform): "
        + bound(k1, row["bytes"], row["flops"], copy_gbs))
    del k1_args, want
    timed = timed_steps(exp, batch, class_embed, smi, "train")
    eval_fwd = eval_forward_rate(exp, (TRAIN_BS, 128), smi, "train")
    exp.log.close()
    del exp, batch

    # (c) two float32 steps, card against CPU, same seeds
    f32, exp, b, ce = f32_card_vs_cpu(argv("float32", CPU_CLIPS, CPU_CLIPS),
                                      dev, "train", "model.stem.0.weight")

    # (d) a NaN batch: the step must leave the optimizer and weights alone
    before = {k: v.detach().clone() for k, v in exp.model.named_parameters()}
    mom = [(exp.optimizer.state[p]["exp_avg"].clone(),
            exp.optimizer.state[p]["exp_avg_sq"].clone())
           for p in exp.model.parameters()]
    count = float(exp.optimizer.count)
    bad = torch.full_like(b["x"], float("nan"))
    m = exp.train_step(bad, b["z"], b["label"], b["weight"], ce)
    torch.cuda.synchronize()
    check(not math.isfinite(float(m["loss"])), "the NaN batch's loss")
    check(all(torch.equal(v, before[k])
              for k, v in exp.model.named_parameters()),
          "a NaN step changed the parameters")
    check(all(torch.equal(exp.optimizer.state[p]["exp_avg"], a)
              and torch.equal(exp.optimizer.state[p]["exp_avg_sq"], v)
              for p, (a, v) in zip(exp.model.parameters(), mom)),
          "a NaN step changed Adam's moments")
    check(float(exp.optimizer.count) == count == 1002
          and int(exp.optimizer.total_notfinite) == 1
          and not bool(exp.optimizer.last_finite),
          "a NaN step changed Adam's step count or was not counted")
    say(f"[train] NaN batch: step skipped on the device (count stays "
        f"{int(count)}, total_notfinite 1), parameters and moments "
        f"unchanged")
    RECORD["train"] = {
        "launches": launches, "dy_copies": copies, "cli_seconds": wall,
        "cli_summary": summary, **timed, "eval_forward": eval_fwd,
        "f32_card_vs_cpu": f32}
    RECORD["k1_train"] = k1
    return launches, k1, summary


def test_embeddings(exp, model=None):
    """The unit embeddings [videos, 300] of exp's test table, as
    Experiment.evaluate computes them (eval-mode BN, the run's dispatch),
    by exp's model or `model`."""
    import numpy as np
    import torch

    from zeroshotvideoclassification_tpu_torch.cli.main import (
        eval_batch_size,
    )
    from zeroshotvideoclassification_tpu_torch.config import transform_dtype
    from zeroshotvideoclassification_tpu_torch.data.pipeline import (
        HostPipeline,
        device_batch,
    )
    from zeroshotvideoclassification_tpu_torch.eval import extract_embeddings
    from zeroshotvideoclassification_tpu_torch.train import eval_step

    cfg, table = exp.config, exp.datasets["testing"][0]
    bs = eval_batch_size(exp.global_bs, table.n_clips, 1, 1, len(table),
                         cfg.eval_clip_budget)
    batches = (device_batch(h, table.n_clips, cfg.clip_len,
                            transform_dtype(cfg), exp.device)
               for h in HostPipeline(table, cfg, bs, seed=cfg.seed))
    model = exp.model if model is None else model
    model.eval()
    pred, _, _ = extract_embeddings(lambda x: eval_step(model, x), batches)
    return torch.from_numpy(np.asarray(pred, np.float32))


def phase_checkpoint(tmp, dev, smi, train_summary):
    """Checkpoints on the card: phase 7's epoch wrote last.npz (and
    checkpoint.npz where its accuracy is above 0); a second Experiment with
    --resume auto holds exactly what the file holds (parameters, BN
    statistics, Adam's moments and counters, the step count), starts at
    epoch 1 and trains it through the kernels (37 / 37 / 1 launches a
    step); --evaluate --weights on the best checkpoint gives the saving
    epoch's embeddings (per-video cosine >= BF16_COSINE_BAR); and the host
    time a checkpoint write takes from the step loop, written at once and
    handed to the asynchronous writer. -> the record."""
    import numpy as np
    import torch

    from zeroshotvideoclassification_tpu_torch.cli import main as train_cli
    from zeroshotvideoclassification_tpu_torch.config import (
        config_from_namespace,
    )
    from zeroshotvideoclassification_tpu_torch.data.datasets import (
        build_datasets,
    )
    from zeroshotvideoclassification_tpu_torch.train import (
        host_state,
        read_meta,
        save_checkpoint,
    )
    from zeroshotvideoclassification_tpu_torch.train.async_ckpt import (
        AsyncCheckpointer,
    )

    args = train_argv(tmp, dev, "bfloat16", TRAIN_BS, TRAIN_BS * TRAIN_STEPS)
    cfg = config_from_namespace(train_cli.build_arg_parser().parse_args(args))
    base = cfg.savename(1)
    best, last = (os.path.join(base, n) for n in ("checkpoint.npz",
                                                  "last.npz"))
    acc0 = train_summary["best_accuracy"]
    check(os.path.exists(last) and read_meta(last)["epoch"] == 0,
          f"phase 7 wrote no last.npz of epoch 0 under {base}")
    check(os.path.exists(best) == (acc0 > 0),
          f"checkpoint.npz written: {os.path.exists(best)}, best accuracy "
          f"{acc0}")
    say(f"[ckpt] phase 7 wrote {'checkpoint.npz and ' * (acc0 > 0)}"
        f"last.npz (epoch 0, {os.path.getsize(last) / 1e6:.1f} MB)")

    # (a) --resume auto: the state the file holds, epoch 1 through the
    # kernels
    rcfg = cfg.replace(resume="auto", n_epochs=2)
    exp = train_cli.Experiment(rcfg, build_datasets(rcfg, None), device=dev)
    check(exp.config.resume == last and exp.start_epoch == 1
          and exp.savename == base, f"resumed {exp.config.resume} at "
          f"{exp.start_epoch} into {exp.savename}")
    snap = host_state(exp.train_step.state)
    with np.load(last) as z:
        held = set(z.files) - {"__meta__"}
        check(held == set(snap), "the restored state's members")
        differ = [k for k in held if z[k].dtype != snap[k].dtype
                  or not np.array_equal(z[k], snap[k])]
    check(not differ, f"restored state differs from last.npz: {differ[:5]}")
    say(f"[ckpt] --resume auto: {len(held)} members of last.npz restored "
        f"bit for bit (parameters, BN statistics, Adam's moments and "
        f"counters, step {exp.train_step.state.step}); starts at epoch "
        f"{exp.start_epoch} in the run's directory")
    saved_emb = test_embeddings(exp)
    # (b) --evaluate --weights on the best checkpoint (last.npz of epoch 0
    # where no epoch improved on 0), before epoch 1 may write a better one:
    # the saving epoch's embeddings
    weights = best if acc0 > 0 else last
    ecfg = cfg.replace(evaluate=True, weights=weights)
    ev = train_cli.Experiment(ecfg, build_datasets(ecfg, None), device=dev)
    emb = test_embeddings(exp, ev.model)  # the training run's test table
    cos = float(torch.nn.functional.cosine_similarity(emb, saved_emb,
                                                      dim=-1).min())
    check(cos >= BF16_COSINE_BAR, f"--evaluate embeddings: cosine {cos}")
    ev_summary = ev.run()
    say(f"[ckpt] --evaluate --weights {os.path.basename(weights)}: "
        f"embeddings of {emb.shape[0]} test videos at per-video cosine >= "
        f"{cos:.6f} of the saving epoch's (bar {BF16_COSINE_BAR}); "
        f"--evaluate's accuracy (its own clips a video) "
        f"{ev_summary['synthetic_test_accuracy']:.1f}, the saving epoch's "
        f"{train_summary['synthetic_test_accuracy']:.1f}")
    del ev

    zero_counts()
    t0 = time.perf_counter()
    summary = exp.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
    check(math.isfinite(summary["loss"]) and summary["loss"] > 0,
          f"resumed loss {summary['loss']}")
    check(exp.train_step.state.step == 2 * TRAIN_STEPS
          and read_meta(last)["epoch"] == 1, "the resumed epoch")
    check(launches == expect(TRAIN_STEPS + 1, 37 * (TRAIN_STEPS + 1),
                             37 * TRAIN_STEPS),
          f"launches of the resumed epoch: {launches}")
    say(f"[ckpt] resumed epoch 1: {TRAIN_STEPS} steps and the evaluation in "
        f"{wall:.1f} s, mean loss {summary['loss']:.5f}, test accuracy "
        f"{summary['synthetic_test_accuracy']:.1f}, launches {launches}")

    # (c) what a write takes from the step loop: the state to host numpy
    # and the npz written at once, or handed to the writer thread
    state = exp.train_step.state
    sync_ms, async_ms, writer_ms, host_ms = [], [], [], []
    for k in range(2):
        path = os.path.join(tmp, f"timed_{k}.npz")
        t0 = time.perf_counter()
        payload = host_state(state)
        t1 = time.perf_counter()
        save_checkpoint(path, payload, 1, 0.0, cfg.to_json())
        t2 = time.perf_counter()
        host_ms.append((t1 - t0) * 1e3)
        sync_ms.append((t2 - t0) * 1e3)
        ck = AsyncCheckpointer()
        t0 = time.perf_counter()
        ck.submit(path, host_state(state), 1, 0.0, cfg.to_json())
        t1 = time.perf_counter()
        ck.close()
        t2 = time.perf_counter()
        async_ms.append((t1 - t0) * 1e3)
        writer_ms.append((t2 - t1) * 1e3)
        os.unlink(path)
    mb = os.path.getsize(last) / 1e6
    say(f"[ckpt] a {mb:.1f} MB checkpoint takes from the step loop "
        f"{statistics.median(sync_ms):.1f} ms written at once ({sync_ms}), "
        f"{statistics.median(async_ms):.1f} ms through the writer thread "
        f"({async_ms}: the state to host numpy, {host_ms} ms of it alone), "
        f"which then writes for {statistics.median(writer_ms):.1f} ms  "
        f"({smi})")
    out = {"file_MB": mb, "restored_members": len(held),
           "resumed_launches": launches, "resumed_summary": summary,
           "resumed_seconds": wall, "evaluate_min_cosine": cos,
           "evaluate_summary": ev_summary, "host_state_ms": host_ms,
           "sync_write_ms": sync_ms, "async_submit_ms": async_ms,
           "writer_ms": writer_ms}
    RECORD["checkpoint"] = out
    del exp
    return out


def sun_motion_args(dev, images=TRAIN_BS, seed=0):
    """K4's operands at the SUN path's shape: `images` seeded images of
    several true sizes on the 256x342 canvas, and for each CLIP_LEN crop
    boxes drawn and turned into taps by the port's host functions."""
    import numpy as np
    import torch

    from zeroshotvideoclassification_tpu_torch.data.stillimages import (
        camera_motion_trajectory,
        motion_resample_indices,
    )

    rng = np.random.default_rng(seed)
    hc, wc = SUN_CANVAS
    sizes = [(hc, wc), (200, 260), (256, 300), (172, 342), (100, 340)]
    canvas = np.zeros((images, hc, wc, 3), np.uint8)
    taps = [[] for _ in range(6)]
    for k in range(images):
        h, w = sizes[k % len(sizes)]  # (100, 340): side-112 boxes overhang
        canvas[k, :h, :w] = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        traj = camera_motion_trajectory((h, w), SIZE, CLIP_LEN, rng)
        for lst, a in zip(taps, motion_resample_indices(traj, (h, w), SIZE)):
            lst.append(a)
    return [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
            for a in (canvas, *(np.stack(t) for t in taps))]


def phase_k4(dev, copy_gbs, smi):
    import numpy as np
    import torch

    from torch_helpers import bf16_ulps
    from zeroshotvideoclassification_tpu_torch.data.stillimages import (
        CH_OFFSET,
        CH_SCALE,
        camera_motion_trajectory,
    )
    from zeroshotvideoclassification_tpu_torch.ops.resample import (
        fused_image_motion_transform,
        fused_image_motion_transform_aa,
    )
    from zeroshotvideoclassification_tpu_torch.ops.resample_cuda import (
        fused_image_motion_transform_cuda,
        image_motion_prepare,
        transform_plan,
    )

    args = sun_motion_args(dev)
    out = {"shapes": []}
    for dt in (torch.float32, torch.bfloat16):
        got = fused_image_motion_transform_cuda(*args, CH_SCALE, CH_OFFSET,
                                                dt)
        torch.cuda.synchronize()
        want = fused_image_motion_transform(*args, CH_SCALE, CH_OFFSET, dt)
        torch.cuda.synchronize()
        err = float((got.float() - want.float()).abs().max())
        ulps = bf16_ulps(got, want)
        if dt == torch.float32:
            check(err <= 2e-6, f"K4 f32: {err}")
        else:
            check(ulps <= 1.0, f"K4 bf16: {ulps} ulp")
        ms = time_ms(lambda: fused_image_motion_transform_cuda(
            *args, CH_SCALE, CH_OFFSET, dt))
        launch, _ = image_motion_prepare(*args, CH_SCALE, CH_OFFSET, dt)
        launch_ms = run_ms(launch)
        plain = time_ms(lambda: fused_image_motion_transform(
            *args, CH_SCALE, CH_OFFSET, dt), reps=5)
        # images and taps read once, the output written once; ~12 float32
        # operations per output value (two lerps and the affine)
        nbytes = (sum(a.numel() * a.element_size() for a in args)
                  + got.numel() * got.element_size())
        b, hc, wc, _ = args[0].shape
        plan = transform_plan(b, CLIP_LEN, hc, wc, SIZE, got.element_size())
        row = {"shape": list(args[0].shape), "frames": CLIP_LEN,
               "dtype": str(dt)[6:], "max_abs_err": err, "bf16_ulps": ulps,
               "ms": ms, "launch_ms": launch_ms, "plain_ms": plain,
               "bytes": nbytes, "flops": 12 * got.numel(), "plan": plan,
               "GB_per_s": nbytes / 1e9 / (launch_ms / 1e3)}
        out["shapes"].append(row)
        say(f"[K4] images {'x'.join(map(str, row['shape']))} x {CLIP_LEN} "
            f"frames -> {row['dtype']}: err {err:.3g} ({ulps:.2f} bf16 ulp)  "
            f"wrapper {ms:.4f} ms, launch alone {launch_ms:.4f} ms "
            f"({row['GB_per_s']:.0f} GB/s; {plan['blocks']} blocks of "
            f"{plan['threads']} threads, a band of {plan['band_rows']} rows "
            f"each, {plan['stage_rows']} rows staged, {plan['smem_bytes']} B "
            f"shared)  plain {plain:.3f} ms")
        del got, want
    out["max_abs_err"] = max(r["max_abs_err"] for r in out["shapes"])
    for k in ("ms", "launch_ms", "plain_ms"):
        out[k] = row[k]
    say(f"[K4] SUN batch of {TRAIN_BS} -> bfloat16: "
        + bound(out, row["bytes"], row["flops"], copy_gbs))

    # the antialiased transform (plain PyTorch on every device) on the same
    # images: its time per batch, and its two implementations against each
    # other (2e-3, the JAX package's bar between them and torch's antialias)
    rng = np.random.default_rng(1)
    true_hw = (SUN_CANVAS[0] * 25 // 32, SUN_CANVAS[1] * 3 // 4)  # 200x256
    hw = np.asarray([true_hw] * TRAIN_BS, np.int32)
    traj = np.stack([camera_motion_trajectory(true_hw, SIZE, CLIP_LEN, rng)
                     for _ in range(TRAIN_BS)])
    aa_args = (args[0], torch.from_numpy(traj.astype(np.int32)).to(dev),
               torch.from_numpy(hw).to(dev), CH_SCALE, CH_OFFSET)
    mxu = fused_image_motion_transform_aa(*aa_args)
    gather = fused_image_motion_transform_aa(*aa_args, impl="gather")
    aa_err = float((mxu - gather).abs().max())
    check(bool(torch.isfinite(mxu).all()) and aa_err <= 2e-3,
          f"antialiased transform: mxu vs gather {aa_err}")
    del gather, mxu
    aa_ms = time_ms(lambda: fused_image_motion_transform_aa(
        *aa_args, out_dtype=torch.bfloat16), reps=5)
    say(f"[K4] antialiased transform (impl=mxu) of the same {TRAIN_BS} "
        f"images -> bfloat16: {aa_ms:.3f} ms per batch; mxu vs gather "
        f"{aa_err:.3g}  ({smi})")
    out["antialiased_ms"], out["aa_mxu_vs_gather"] = aa_ms, aa_err
    RECORD["k4"] = out
    return out


def k4_trace(dev, k4, smi):
    """K4's device time in a torch.profiler trace of LAUNCH_RUN wrapper
    calls at the SUN path's shape, f32 and bf16, into phase 8's record
    (trace_ms: bf16). Run last: after a profiler run in a process, every
    launch costs the host more, which would move the later phases'
    timings."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from zeroshotvideoclassification_tpu_torch.data.stillimages import (
        CH_OFFSET,
        CH_SCALE,
    )
    from zeroshotvideoclassification_tpu_torch.ops.resample_cuda import (
        fused_image_motion_transform_cuda,
    )

    args = sun_motion_args(dev)
    for row, dt in zip(k4["shapes"], (torch.float32, torch.bfloat16)):
        def call():
            return fused_image_motion_transform_cuda(*args, CH_SCALE,
                                                     CH_OFFSET, dt)

        call()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(LAUNCH_RUN):
                call()
            torch.cuda.synchronize()
        kernels = [e for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and "ImageMotion" in e.name]
        check(len(kernels) == LAUNCH_RUN,
              f"K4 trace: {len(kernels)} kernels for {LAUNCH_RUN} calls")
        row["trace_ms"] = sum(e.time_range.elapsed_us()
                              for e in kernels) / 1e3 / LAUNCH_RUN
        say(f"[K4] {row['dtype']}: {row['trace_ms']:.4f} ms of device time "
            f"a call in a trace of {LAUNCH_RUN} calls (wrapper "
            f"{row['ms']:.4f}, launch alone {row['launch_ms']:.4f}; bound "
            f"{row['bytes'] / HBM_BYTES_PER_S * 1e3:.4f})  ({smi})")
    k4["trace_ms"] = k4["shapes"][-1]["trace_ms"]


def write_sun_images(tmp, n):
    """n seeded image files (the last path does not exist), in sizes that
    pass through load_and_bound_image as they are, get bounded up (min side
    < 172) or down (> 512), and exceed the 256x342 canvas so that
    HostPipeline._fit_image shrinks them. -> paths."""
    import cv2
    import numpy as np

    rng = np.random.default_rng(7)
    sizes = [(200, 260), (240, 320), (120, 150), (60, 80), (600, 800),
             (300, 1000), (256, 342), (375, 500)]
    root = os.path.join(tmp, "sun")
    os.makedirs(root, exist_ok=True)
    paths = []
    for k in range(n - 1):
        h, w = sizes[k % len(sizes)]
        base = rng.integers(0, 256, (h // 8 + 1, w // 8 + 1, 3))
        img = np.kron(base, np.ones((8, 8, 1)))[:h, :w]
        img = np.clip(img + rng.normal(0, 8, img.shape), 0, 255)
        path = os.path.join(root, f"img{k:03d}.jpg")
        check(cv2.imwrite(path, img.astype(np.uint8)), f"writing {path}")
        paths.append(path)
    paths.append(os.path.join(root, "missing.jpg"))
    return paths


def phase_sun(tmp, dev, smi):
    """SUN still-image training through cli.main's Experiment, with the
    zero-shot evaluation of a video test table. -> (launches of the
    --no-sun_antialias run, the record)."""
    import numpy as np
    import torch

    from torch_helpers import seed_adam
    from zeroshotvideoclassification_tpu_torch.cli import main as train_cli
    from zeroshotvideoclassification_tpu_torch.config import (
        config_from_namespace,
        transform_dtype,
    )
    from zeroshotvideoclassification_tpu_torch.data.datasets import VideoTable
    from zeroshotvideoclassification_tpu_torch.data.pipeline import (
        HostPipeline,
        device_batch,
    )
    from zeroshotvideoclassification_tpu_torch.data.synthetic import (
        build_synthetic_datasets,
        class_embeddings,
    )

    n_images = TRAIN_BS * SUN_STEPS
    t0 = time.perf_counter()
    paths = write_sun_images(tmp, n_images)
    say(f"[sun] {n_images - 1} seeded image files and one missing path "
        f"written in {time.perf_counter() - t0:.1f} s")
    n_classes = 8
    labels = (np.arange(n_images) % n_classes).astype(np.int32)

    def config(dtype, bs, aa):
        argv = ["--dataset", "sun2both", "--network", "r2plus1d_18", "--bs",
                str(bs), "--n_epochs", "1", "--compute_dtype", dtype,
                "--save_path", os.path.join(tmp, "sun_runs"),
                "--no-progressbar", "--nopretrained", "--device", str(dev),
                "--sun_antialias" if aa else "--no-sun_antialias"]
        return config_from_namespace(
            train_cli.build_arg_parser().parse_args(argv))

    def datasets(cfg, n):
        table = VideoTable(
            name="sun", fnames=np.asarray(paths[-n:], object),
            label_idx=labels[-n:], classes=[f"scene{c}" for c in
                                            range(n_classes)],
            class_embed=class_embeddings(range(100, 100 + n_classes)),
            loader="image", is_validation=False, n_clips=1)
        return {"training": [table],
                "testing": build_synthetic_datasets(cfg)["testing"]}

    # (a) one epoch for each transform, ending in the evaluation
    out = {}
    for aa in (False, True):
        tag = "antialiased" if aa else "no-sun_antialias"
        cfg = config("bfloat16", SUN_BS, aa)
        data = datasets(cfg, n_images)
        exp = train_cli.Experiment(cfg, data, device=dev)
        check(exp.train_bs == TRAIN_BS and exp.global_bs == SUN_BS,
              f"halved batch {exp.train_bs} of {exp.global_bs}")
        zero_counts()
        t0 = time.perf_counter()
        summary = exp.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_counts()
        say(f"[sun] {tag}: Experiment.run, --bs {SUN_BS} -> {exp.train_bs} "
            f"images a step: {exp.train_step.state.step} steps and the "
            f"evaluation in {wall:.1f} s, mean loss {summary['loss']:.5f}, "
            f"test accuracy {summary['synthetic_test_accuracy']:.1f}, best "
            f"accuracy {summary['best_accuracy']:.1f}, launches {launches}")
        check(exp.train_step.state.step == SUN_STEPS, "steps of the epoch")
        check(math.isfinite(summary["loss"]) and summary["loss"] > 0,
              f"SUN loss {summary['loss']}")
        check(isinstance(summary["best_accuracy"], float)
              and 0 <= summary["best_accuracy"] <= 100
              and summary["best_accuracy"]
              == summary["synthetic_test_accuracy"],
              f"SUN accuracy {summary}")
        check(int(exp.optimizer.total_notfinite) == 0, "a SUN step skipped")
        # one K4 launch per step without the antialiasing, none with it; the
        # evaluation is one dispatch of 16 one-clip videos (K1 + 37 K2)
        check(launches == {
            **expect(1, 37 * (SUN_STEPS + 1), 37 * SUN_STEPS),
            "image_motion_transform": 0 if aa else SUN_STEPS},
            f"SUN launches ({tag}): {launches}")
        out[tag] = {"launches": launches, "summary": summary,
                    "seconds": wall}
        del exp
    sun_launches = out["no-sun_antialias"]["launches"]

    # (b) timed steps on one repeated image batch (the antialiased default)
    table = data["training"][0]
    host = next(iter(HostPipeline(table, cfg, TRAIN_BS, seed=cfg.seed)))
    check(host.image_mode and host.trajectory is not None
          and host.canvas.shape == (TRAIN_BS, *SUN_CANVAS, 3)
          and float(host.weight.sum()) in (TRAIN_BS - 1.0, float(TRAIN_BS)),
          "SUN host batch")
    exp = train_cli.Experiment(cfg, data, device=dev)
    batch = device_batch(host, 1, cfg.clip_len, transform_dtype(cfg), dev)
    check(tuple(batch["x"].shape) == (TRAIN_BS, 1, CLIP_LEN, SIZE, SIZE, 3)
          and batch["x"].dtype == torch.bfloat16
          and bool(torch.isfinite(batch["x"].float()).all()),
          "SUN train batch")
    class_embed = torch.from_numpy(np.asarray(table.class_embed,
                                              np.float32)).to(dev)
    out.update(timed_steps(exp, batch, class_embed, smi, "sun"))
    exp.log.close()
    del exp, batch

    # (c) one float32 step of CPU_CLIPS images, card against CPU, for both
    # transforms (K4 against its plain version inside the whole step)
    out["f32_card_vs_cpu"] = {}
    for aa in (False, True):
        cfg32 = config("float32", 2 * CPU_CLIPS, aa)
        data32 = datasets(cfg32, 2 * CPU_CLIPS)  # the missing file among them
        table = data32["training"][0]
        host = next(iter(HostPipeline(table, cfg32, CPU_CLIPS,
                                      seed=cfg32.seed)))
        ce_np = np.asarray(table.class_embed, np.float32)
        runs = {}
        for d in ("cpu", dev):
            exp = train_cli.Experiment(cfg32, data32, device=d)
            check(exp.train_bs == CPU_CLIPS, "halved float32 batch")
            seed_adam(exp.optimizer, exp.model, seed=3, count=1000)
            b = device_batch(host, 1, cfg32.clip_len, torch.float32, d)
            ce = torch.from_numpy(ce_np).to(d)
            loss = float(exp.train_step(b["x"], b["z"], b["label"],
                                        b["weight"], ce)["loss"])
            runs[str(d)] = (loss, b["x"].cpu(), {
                k: v.detach().cpu().clone()
                for k, v in exp.model.named_parameters()})
            exp.log.close()
            del exp, b
        (l_cpu, x_cpu, p_cpu), (l_gpu, x_gpu, p_gpu) = (runs["cpu"],
                                                        runs[str(dev)])
        xerr = float((x_gpu - x_cpu).abs().max())
        rel = abs(l_gpu - l_cpu) / abs(l_cpu)
        dmax = max(float((p_gpu[k] - p_cpu[k]).abs().max()) for k in p_cpu)
        tag = "antialiased" if aa else "no-sun_antialias"
        # the 2-tap transform repeats the plain version's operations; the
        # antialiased one sums its products in another order on the card
        xbar = 1e-4 if aa else 2e-6
        say(f"[sun] {tag}: one float32 step of {CPU_CLIPS} images, card vs "
            f"CPU: input differs by {xerr:.3g} (bar {xbar}), loss {l_gpu} "
            f"vs {l_cpu} (rel {rel:.2g}, bar 1e-4), parameters by at most "
            f"{dmax:.3g} (bar 2e-5)")
        check(xerr <= xbar, f"SUN input card vs CPU ({tag}): {xerr}")
        check(rel <= 1e-4, f"SUN loss card vs CPU ({tag}): {l_gpu} {l_cpu}")
        check(dmax <= 2e-5, f"SUN parameters card vs CPU ({tag}): {dmax}")
        out["f32_card_vs_cpu"][tag] = {"input_max_abs": xerr,
                                       "loss_rel": rel,
                                       "param_max_abs": dmax}
    RECORD["sun"] = out
    return sun_launches, out


K3_SHAPES = [  # (x [N, T, H, W, Ci], Co): layer1, then two ragged midplanes
    ((16, 16, 56, 56, 144), 64), ((16, 8, 28, 28, 230), 128),
    ((16, 2, 7, 7, 921), 512)]


def phase_k3(dev, copy_gbs, smi):
    """The temporal conv op against its plain version and beside F.conv3d.
    -> (launches of the op driven through its public entry, the record)."""
    import torch
    import torch.nn.functional as F

    from torch_helpers import bf16_ulps
    from zeroshotvideoclassification_tpu_torch.ops.temporal_conv import (
        temporal_conv3,
        temporal_conv3_cuda,
        temporal_conv3_plain,
        tile_plan,
    )

    g = torch.Generator(device=dev).manual_seed(2)
    out = {"max_abs_err": 0.0, "shapes": []}
    for shape, co in K3_SHAPES:
        ci = shape[-1]
        x32 = torch.randn(shape, device=dev, generator=g)
        w32 = (torch.randn((3, 1, 1, ci, co), device=dev, generator=g)
               / (3 * ci) ** 0.5)  # outputs of O(1)
        for dt in (torch.float32, torch.bfloat16):
            x, w = x32.to(dt), w32.to(dt)
            got = temporal_conv3_cuda(x, w)
            torch.cuda.synchronize()
            want = temporal_conv3_plain(x, w)
            torch.cuda.synchronize()
            diff = (got.float() - want.float()).abs()
            err = float(diff.max())
            what = f"K3 {shape}->{co} {str(dt)[6:]}"
            if dt == torch.float32:
                ulps = None
                check(bool((diff <= 1e-5 + 1e-5 * want.abs()).all()),
                      f"{what}: {err}")
            else:
                # both sides round one float32 sum to bf16, and the two sums
                # differ by up to the float32 bar (another order over 3 * Ci
                # products): 2 ulp of the plain value beyond that bar, which
                # only counts where an output cancels to nearly zero
                ulps = bf16_ulps((diff - 1e-5).clamp_min(0) + want.float(),
                                 want)
                check(ulps <= 2.0, f"{what}: {ulps} ulp beyond 1e-5")
            del diff
            out["max_abs_err"] = max(out["max_abs_err"], err)
            del got, want
            ms = time_ms(lambda: temporal_conv3_cuda(x, w))
            plain = time_ms(lambda: temporal_conv3_plain(x, w), reps=5)
            # the library call: cuDNN on the same x (its channels-last-3d
            # view) and the weight laid out for it, benchmark mode on
            xv = x.permute(0, 4, 1, 2, 3)
            wv = w.permute(4, 3, 0, 1, 2).contiguous(
                memory_format=torch.channels_last_3d)
            lib = time_ms(lambda: F.conv3d(xv, wv, padding=(1, 0, 0)))
            lib_err = float((F.conv3d(xv, wv, padding=(1, 0, 0))
                             .permute(0, 2, 3, 4, 1).float()
                             - temporal_conv3_cuda(x, w).float()).abs().max())
            rows = shape[0] * shape[1] * shape[2] * shape[3]
            nbytes = (x.numel() + w.numel() + rows * co) * x.element_size()
            flops = 2 * rows * 3 * ci * co
            plan = tile_plan(shape[0], shape[1], shape[2] * shape[3], ci, co,
                             dt, 16 if x.data_ptr() % 16 == 0 else 2)
            row = {"shape": list(shape), "co": co, "dtype": str(dt)[6:],
                   "kernel": plan["kernel"], "staging": plan["staging"],
                   "max_abs_err": err, "bf16_ulps": ulps, "ms": ms,
                   "plain_ms": plain, "library_ms": lib,
                   "vs_library_max_abs": lib_err, "bytes": nbytes,
                   "flops": flops, "TFLOP_per_s": flops / 1e12 / (ms / 1e3)}
            peak = (BF16_FLOPS_PER_S if dt == torch.bfloat16
                    else F32_FLOPS_PER_S)
            text = bound(row, nbytes, flops, copy_gbs, peak)
            out["shapes"].append(row)
            say(f"[K3] {'x'.join(map(str, shape))} -> {co} {row['dtype']}: "
                f"err {err:.3g} ("
                + ("" if ulps is None else f"{ulps:.2f} bf16 ulp; ")
                + f"{lib_err:.3g} from F.conv3d)  {plan['kernel']} kernel, "
                f"{plan['staging']} staging, {plan['blocks']} blocks of "
                f"{plan['threads']}: {ms:.3f} "
                f"ms ({row['TFLOP_per_s']:.1f} TFLOP/s = "
                f"{100 * row['TFLOP_per_s'] * 1e12 / peak:.1f}% of the "
                f"{peak / 1e12:.0f} TFLOP/s peak)  plain {plain:.3f} ms  "
                f"F.conv3d {lib:.3f} ms ({ms / lib:.2f}x); " + text)
            del x, w, xv, wv
        del x32, w32
    # the gradients once, at a ragged shape in float32: the op's backward
    # (the library convolution's gradient) against the plain version's
    # autograd gradient, within 1e-4 of each gradient's largest entry
    shape, co = (4, 4, 14, 14, 230), 128
    x = torch.randn(shape, device=dev, generator=g).requires_grad_()
    w = (torch.randn((3, 1, 1, shape[-1], co), device=dev, generator=g)
         / (3 * shape[-1]) ** 0.5).requires_grad_()
    dy = torch.randn((*shape[:4], co), device=dev, generator=g)
    with torch.enable_grad():
        got = torch.autograd.grad(
            (temporal_conv3(x, w, torch.float32) * dy).sum(), (x, w))
        xf, wf = x, w[:, 0, 0]
        y = xf @ wf[1]
        y = y + F.pad(xf[:, :-1] @ wf[0], (0, 0) * 3 + (1, 0))
        y = y + F.pad(xf[:, 1:] @ wf[2], (0, 0) * 3 + (0, 1))
        want = torch.autograd.grad((y * dy).sum(), (x, w))
    grad_rel = 0.0
    for name, a, b in zip(("dx", "dw"), got, want):
        rel = float((a - b).abs().max() / b.abs().max())
        check(rel <= 1e-4, f"K3 {name}: off by {rel} of its largest entry")
        grad_rel = max(grad_rel, rel)
    say(f"[K3] gradients at {shape} -> {co} float32 within {grad_rel:.2g} "
        f"of their largest entry of the plain version's (bar 1e-4)")
    del x, w, dy, got, want, y

    # the op as a user calls it, counted: bf16 (the default) and float32
    zero_counts()
    shape, co = K3_SHAPES[0]
    x = torch.randn(shape, device=dev, generator=g)
    w = torch.randn((3, 1, 1, shape[-1], co), device=dev, generator=g)
    for dt in (torch.bfloat16, torch.float32):
        y = temporal_conv3(x, w, dt)
        check(y.dtype == dt and tuple(y.shape) == (*shape[:4], co)
              and bool(torch.isfinite(y.float()).all()), "temporal_conv3")
    torch.cuda.synchronize()
    launches = read_counts()
    check(launches["temporal_conv3"] == 2, f"K3 launches: {launches}")
    main_row = next(r for r in out["shapes"] if r["shape"] == list(shape)
                    and r["dtype"] == "bfloat16")
    for k in ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
              "copy_bound_ms"):
        out[k] = main_row[k]
    out["grad_max_rel_err"] = grad_rel
    say(f"[K3] layer1 shape in bf16: kernel {out['ms']:.3f} ms, plain "
        f"{out['plain_ms']:.3f} ms, F.conv3d {out['library_ms']:.3f} ms, "
        f"bound {out['bound_ms']:.3f} ms ({out['bound_by']}); launches "
        f"through the op: {launches['temporal_conv3']}  ({smi})")
    RECORD["k3"] = out
    return launches, out


def phase_model(paths, dev):
    import numpy as np
    import torch

    from torch_helpers import calibrate_bn, copy_bn
    from zeroshotvideoclassification_tpu_torch.cli.infer import load_model
    from zeroshotvideoclassification_tpu_torch.config import Config
    from zeroshotvideoclassification_tpu_torch.data.pipeline import (
        device_batch,
    )
    from zeroshotvideoclassification_tpu_torch.ops.cdist import (
        cosine_distances,
    )
    from zeroshotvideoclassification_tpu_torch.train import eval_step

    def cfg(dt):
        return Config(network="r2plus1d_18", head="mlp", size=SIZE,
                      clip_len=CLIP_LEN, n_clips=N_CLIPS, compute_dtype=dt)

    hb = host_batch(paths[:2], 2)
    m32, _ = load_model(cfg("float32"), None, dev)
    calibrate_bn(m32, device_batch(hb, N_CLIPS, CLIP_LEN, torch.float32,
                                   dev)["x"], BN_SEED)
    m_cpu = copy_bn(m32, load_model(cfg("float32"), None, "cpu")[0])
    m16 = copy_bn(m32, load_model(cfg("bfloat16"), None, dev)[0])
    t0 = time.perf_counter()
    e_cpu = eval_step(m_cpu, device_batch(hb, N_CLIPS, CLIP_LEN,
                                          torch.float32, "cpu")["x"])
    cpu_s = time.perf_counter() - t0
    e32 = eval_step(m32, device_batch(hb, N_CLIPS, CLIP_LEN, torch.float32,
                                      dev)["x"]).cpu()
    e16 = eval_step(m16, device_batch(hb, N_CLIPS, CLIP_LEN, torch.bfloat16,
                                      dev)["x"]).cpu()
    err32 = float((e32 - e_cpu).abs().max())
    cos16 = torch.nn.functional.cosine_similarity(e16, e_cpu, dim=1)
    say(f"[model] r2plus1d_18+mlp, 2 videos x {N_CLIPS} clips x "
        f"{CLIP_LEN}x{SIZE}x{SIZE}: GPU f32 vs CPU f32 max abs "
        f"{err32:.3g} (bar 1e-4); GPU bf16 vs CPU f32 cosine "
        f"{[round(float(c), 6) for c in cos16]} (bar {BF16_COSINE_BAR}); "
        f"CPU forward {cpu_s:.1f} s")
    check(e_cpu.shape == (2, 300) and bool(torch.isfinite(e16).all()),
          "embedding shape / finiteness")
    check(err32 <= 1e-4, f"GPU f32 vs CPU f32: {err32}")
    check(float(cos16.min()) >= BF16_COSINE_BAR, f"bf16 cosine {cos16}")

    # the direct f32 classification: every video's f32 embedding is a class
    hb_all = host_batch(paths, N_VIDEOS)
    proto = eval_step(m32, device_batch(hb_all, N_CLIPS, CLIP_LEN,
                                        torch.float32, dev)["x"])
    dist = cosine_distances(proto, proto).cpu().numpy()
    off = dist + np.eye(N_VIDEOS) * 9
    say(f"[model] 16 class prototypes (f32 embeddings of the 16 videos): "
        f"smallest distance between two = {off.min():.3g}")
    check(off.min() > 1e-4, "prototypes too close to rank")
    RECORD["model"] = {"gpu_f32_vs_cpu_max_abs": err32,
                       "bf16_vs_cpu_cosine": [float(c) for c in cos16],
                       "prototype_min_distance": float(off.min())}
    return m32, m16, proto.cpu().numpy(), dist.argmin(axis=1)


def post(url, payload):
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 method="POST")
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=600) as r:
        body = json.loads(r.read())
        check(r.status == 200, f"POST {url}: {r.status}")
    return body, time.perf_counter() - t0


def get(url):
    with urllib.request.urlopen(url, timeout=60) as r:
        return json.loads(r.read())


def phase_serve(paths, prepare, proto, expected, dev, smi, tag="serve",
                network="r2plus1d_18", epilogues=37, more_buckets=(64, 128)):
    """The port's engine (bf16, `network`, its weights set by
    `prepare(model)`) behind the HTTP server: every served top_class equal
    to `expected` (the direct f32 classification), one K1 and `epilogues`
    K2 launches a dispatch; forward clips/s per bucket. -> launches."""
    import torch

    from zeroshotvideoclassification_tpu_torch.serve import (
        InferenceEngine,
        start_server,
    )

    names = [f"video{k:02d}" for k in range(N_VIDEOS)]
    engine = InferenceEngine(
        names, proto, network=network, head="mlp", weights=None,
        n_clips=N_CLIPS, clip_len=CLIP_LEN, size=SIZE, max_batch=MAX_BATCH,
        compute_dtype="bfloat16", device=dev)
    prepare(engine.model)
    server = service = None
    try:
        t0 = time.perf_counter()
        engine.warmup()
        say(f"[{tag}] warmup of ladder {engine.batch_buckets}: "
            f"{time.perf_counter() - t0:.2f} s")
        server, service = start_server(engine, port=0)
        url = f"http://127.0.0.1:{server.server_address[1]}"
        requests = [paths[:1], paths[1:6], paths[6:16]]
        # two rounds of the same concurrent requests: the first dispatch on
        # the batcher's own thread pays that thread's CUDA library set-up
        rounds = [[None] * len(requests) for _ in range(2)]

        def send(rnd, i):
            rounds[rnd][i] = post(url + "/classify", {"videos": requests[i]})

        zero_counts()
        for rnd in range(len(rounds)):
            threads = [threading.Thread(target=send, args=(rnd, i))
                       for i in range(len(requests))]
            for th in threads:
                th.start()
            for th in threads:
                th.join(timeout=600)
        launches = read_counts()
        check(all(r is not None for rnd in rounds for r in rnd),
              "a request failed")
        health = get(url + "/healthz")
        stats = get(url + "/stats")
    finally:
        if server is not None:
            server.shutdown()
            server.server_close()
            service.close()
        engine.close()
    check(health["status"] == "ok", f"healthz {health}")
    lat = []
    for rnd, results in enumerate(rounds):
        lat.append([secs for _, secs in results])
        for req, (body, _) in zip(requests, results):
            check(len(body["results"]) == len(req), "one result per video")
            for r, path in zip(body["results"], req):
                check(set(r) == {"video", "top_class", "topk"}
                      and r["video"] == path and len(r["topk"]) == 5
                      and all(set(t) == {"class", "similarity"}
                              for t in r["topk"]), f"result schema: {r}")
                want = names[int(expected[paths.index(path)])]
                check(r["top_class"] == want,
                      f"{path}: served {r['top_class']}, f32 says {want}")
        say(f"[{tag}] round {rnd + 1}: {len(requests)} concurrent POST "
            f"/classify of {[len(r) for r in requests]} videos, latency "
            f"{[round(s, 3) for s in lat[-1]]} s  ({smi})")
    say(f"[{tag}] every top_class = the direct f32 classification; "
        f"dispatches {stats['engine']['batch_buckets']}, device_seconds "
        f"{stats['engine']['device_seconds']}; launches {launches}")
    n = stats["engine"]["dispatches"]
    check(n > 0 and launches == expect(n, epilogues * n, 0),
          f"launches of {n} dispatches: {launches}")

    # forward throughput per bucket (model only, input already on the card),
    # on this ladder and on the serve CLI's default one (max_batch 128)
    fwd = {}
    model = engine.model
    from zeroshotvideoclassification_tpu_torch.train import eval_step

    for b in engine.batch_buckets + list(more_buckets):
        x = torch.rand((b, N_CLIPS, CLIP_LEN, SIZE, SIZE, 3), device=dev,
                       dtype=torch.float32).sub_(0.5).to(torch.bfloat16)
        ms = time_ms(lambda: eval_step(model, x), reps=5 if b <= 32 else 2)
        fwd[b] = {"ms": ms, "clips_per_s": b * N_CLIPS / (ms / 1e3)}
        say(f"[{tag}] forward bucket {b} ({b * N_CLIPS} clips) bf16: "
            f"{ms:.2f} ms = {fwd[b]['clips_per_s']:.1f} clips/s  ({smi})")
        del x
    RECORD[tag] = {"latency_s": lat, "launches": launches, "stats": stats,
                   "forward": fwd}
    return launches


# ----------------------------------------- the P8 paths (phases 11-15) ----

def expect(k1, fwd, bwd, sums=None, channelwise=0):
    """The kernels' launch counts of a video path: K1, K2 forward and
    backward, the BN statistics' sums and moments and their gradients,
    X3D's channel-wise convs, nothing else. Each K2 backward is a
    train-mode BN's, whose statistics took each op and each gradient once:
    all default to `bwd`; `sums` counts the train-mode forwards (each one
    sums and one moments) where some run without a backward;
    `channelwise` counts each channel-wise kernel (forward, data and weight
    gradient) of train steps."""
    stats = bwd if sums is None else sums
    return {"video_transform": k1, "bn_apply_relu": fwd,
            "bn_apply_relu_bwd": bwd, "bn_sums": stats, "bn_sums_grad": bwd,
            "bn_moments": stats, "bn_moments_grad": bwd,
            "image_motion_transform": 0, "temporal_conv3": 0,
            "channelwise_fwd": channelwise, "channelwise_dgrad": channelwise,
            "channelwise_wgrad": channelwise}


def cli_epoch(args, tag, want):
    """One epoch (and the zero-shot evaluation of its 16 test videos, one
    dispatch) through cli.main with `args`, the kernels' launches counted
    around it and held to `want`. -> (summary, launches, seconds)."""
    import torch

    from zeroshotvideoclassification_tpu_torch.cli import main as train_cli

    zero_counts()
    t0 = time.perf_counter()
    summary = train_cli.main(args)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
    say(f"[{tag}] cli.main {' '.join(args)}: an epoch and the zero-shot "
        f"evaluation in {wall:.1f} s (cuDNN's "
        f"algorithm timing included), mean loss {summary['loss']:.5f}, "
        f"test accuracy {summary['synthetic_test_accuracy']:.1f}, "
        f"launches {launches}")
    check(math.isfinite(summary["loss"]) and summary["loss"] > 0,
          f"{tag}: cli.main loss {summary['loss']}")
    check(0 <= summary["synthetic_test_accuracy"] <= 100,
          f"{tag}: cli.main accuracy {summary}")
    check(launches == want, f"{tag}: launches {launches}, want {want}")
    return summary, launches, wall


def experiment(args, dev, bs=TRAIN_BS):
    """cli.main's Experiment for `args`, one host batch of `bs` clips of
    its synthetic training table and the table's class embeddings on the
    card. -> (exp, host batch, class embeddings)."""
    import numpy as np
    import torch

    from zeroshotvideoclassification_tpu_torch.cli import main as train_cli
    from zeroshotvideoclassification_tpu_torch.config import (
        config_from_namespace,
    )
    from zeroshotvideoclassification_tpu_torch.data.datasets import (
        build_datasets,
    )
    from zeroshotvideoclassification_tpu_torch.data.pipeline import (
        HostPipeline,
    )

    cfg = config_from_namespace(train_cli.build_arg_parser().parse_args(args))
    datasets = build_datasets(cfg, None)
    exp = train_cli.Experiment(cfg, datasets, device=dev)
    table = datasets["training"][0]
    host = next(iter(HostPipeline(table, cfg, bs, seed=cfg.seed)))
    ce = torch.from_numpy(np.asarray(table.class_embed, np.float32)).to(dev)
    return exp, host, ce


def to_card(exp, host):
    """device_batch of `host` for `exp` (K1: one launch)."""
    from zeroshotvideoclassification_tpu_torch.config import transform_dtype
    from zeroshotvideoclassification_tpu_torch.data.pipeline import (
        device_batch,
    )

    return device_batch(host, 1, exp.config.clip_len,
                        transform_dtype(exp.config), exp.device)


def phase_train_c3d(tmp, dev, smi):
    """C3D through the training CLI at full width (--bs 16, bf16 over
    float32 masters, random init): C3D_STEPS steps and the evaluation, one
    K1 launch a step and a dispatch and no K2; timed steps, peak memory and
    the evaluation's clips/s; two float32 steps card vs CPU with seeded He
    weights (torch_helpers.calibrate_c3d) and dropout at rate 0 on both
    sides. -> launches."""
    from torch_helpers import calibrate_c3d

    args = cli_argv(tmp, dev, "bfloat16", TRAIN_BS, TRAIN_BS * C3D_STEPS,
                    network="c3d")
    summary, launches, _ = cli_epoch(args, "train_c3d",
                                     expect(C3D_STEPS + 1, 0, 0))
    exp, host, ce = experiment(args, dev)
    check(exp.model.head == "c3d" and exp.model.dropout_rate == 0.1,
          "C3D's head")
    batch = to_card(exp, host)
    timed = timed_steps(exp, batch, ce, smi, "train_c3d")
    eval_fwd = eval_forward_rate(exp, (TRAIN_BS, 128), smi, "train_c3d")
    exp.log.close()
    del exp, batch

    def prepare(model):
        calibrate_c3d(model, C3D_SEED)
        model.dropout_rate = 0.0

    f32, exp, _, _ = f32_card_vs_cpu(
        cli_argv(tmp, dev, "float32", CPU_CLIPS, CPU_CLIPS, network="c3d"),
        dev, "train_c3d", "conv1.weight", prepare)
    del exp
    RECORD["train_c3d"] = {"launches": launches, "cli_summary": summary,
                           **timed, "eval_forward": eval_fwd,
                           "f32_card_vs_cpu": f32}
    return launches


def phase_serve_c3d(paths, dev, smi):
    """C3D served by the port's engine (phase 5's requests, bf16, seeded
    He weights): every top_class the direct f32 classification's, one K1
    launch a dispatch. -> launches."""
    import numpy as np
    import torch

    from torch_helpers import calibrate_c3d
    from zeroshotvideoclassification_tpu_torch.cli.infer import load_model
    from zeroshotvideoclassification_tpu_torch.config import Config
    from zeroshotvideoclassification_tpu_torch.data.pipeline import (
        device_batch,
    )
    from zeroshotvideoclassification_tpu_torch.ops.cdist import (
        cosine_distances,
    )
    from zeroshotvideoclassification_tpu_torch.train import eval_step

    cfg = Config(network="c3d", size=SIZE, clip_len=CLIP_LEN,
                 n_clips=N_CLIPS, compute_dtype="float32")
    m32, _ = load_model(cfg, None, dev)
    calibrate_c3d(m32, C3D_SEED)
    proto = eval_step(m32, device_batch(host_batch(paths, N_VIDEOS), N_CLIPS,
                                        CLIP_LEN, torch.float32, dev)["x"])
    dist = cosine_distances(proto, proto).cpu().numpy()
    off = dist + np.eye(N_VIDEOS) * 9
    say(f"[serve_c3d] 16 class prototypes (f32 C3D embeddings of the 16 "
        f"videos): smallest distance between two = {off.min():.3g}")
    check(off.min() > 1e-4, "C3D prototypes too close to rank")
    del m32
    launches = phase_serve(paths, lambda m: calibrate_c3d(m, C3D_SEED),
                           proto.cpu().numpy(), dist.argmin(axis=1), dev,
                           smi, tag="serve_c3d", network="c3d", epilogues=0,
                           more_buckets=())
    RECORD["serve_c3d"]["prototype_min_distance"] = float(off.min())
    return launches


def phase_train_resnet18(tmp, dev, smi, copy_gbs):
    """--network resnet18 (r3d_18 + the linear head) through the training
    CLI: 20 K2 forward and 20 K2 backward epilogues and one K1 launch a
    step; K2 forward and backward against their plain versions and timed
    at r3d_18's epilogue shapes (phase 6 on that model); timed steps.
    -> (launches, K2 forward's record, K2 backward's)."""
    import torch

    from zeroshotvideoclassification_tpu_torch.cli.infer import load_model
    from zeroshotvideoclassification_tpu_torch.config import Config

    m, _ = load_model(Config(network="resnet18", size=SIZE, clip_len=CLIP_LEN,
                             compute_dtype="float32"), None, dev)
    calls = epilogue_calls(m, torch.zeros(
        (TRAIN_BS, 1, CLIP_LEN, SIZE, SIZE, 3), device=dev))
    check(m.head == "linear" and sum(calls.values()) == 20,
          f"resnet18's epilogues {calls}")
    del m
    k2b, k2f = phase_k2_bwd(calls, dev, copy_gbs, key="_r3d")
    args = cli_argv(tmp, dev, "bfloat16", TRAIN_BS, TRAIN_BS * P8_STEPS,
                    network="resnet18")
    summary, launches, _ = cli_epoch(args, "train_r3d_linear", expect(
        P8_STEPS + 1, 20 * (P8_STEPS + 1), 20 * P8_STEPS))
    exp, host, ce = experiment(args, dev)
    timed = timed_steps(exp, to_card(exp, host), ce, smi, "train_r3d_linear")
    exp.log.close()
    RECORD["train_r3d_linear"] = {"launches": launches,
                                  "cli_summary": summary, **timed}
    return launches, k2f, k2b


def phase_train_x3d(tmp, dev, smi, copy_gbs):
    """15b: X3D-M's BN kernels against their plain versions at its 84
    train-mode BNs of X3D_BS clips and its channel-wise conv kernels at its
    27 convs, then one step of cli.main's Experiment with the counters
    reset just before it, that step again in a torch.profiler trace (the
    channel-wise kernels' launches and device time, no cuDNN grouped
    kernel), and timed steps. -> (that step's launches, K1's record, K2
    forward's, K2 backward's, the statistics', the channel-wise
    convs')."""
    import numpy as np
    import torch

    from torch_helpers import bf16_ulps
    from zeroshotvideoclassification_tpu_torch.cli.infer import load_model
    from zeroshotvideoclassification_tpu_torch.config import Config

    m, _ = load_model(Config(network="x3d_m", size=X3D_SIZE,
                             clip_len=CLIP_LEN, compute_dtype="float32"),
                      None, dev)
    calls = epilogue_calls(m, torch.zeros(
        (X3D_BS, 1, CLIP_LEN, X3D_SIZE, X3D_SIZE, 3), device=dev))
    check(sum(calls.values()) == 84 and len({k[0] for k in calls}) == 13,
          f"x3d_m's epilogues {calls}")
    del m
    torch.cuda.empty_cache()
    k2b, k2f = phase_k2_bwd(calls, dev, copy_gbs, key="_x3d", clips=X3D_BS)
    torch.cuda.empty_cache()
    stats = phase_bn_stats(calls, dev, copy_gbs, clips=X3D_BS, key="_x3d")
    torch.cuda.empty_cache()
    dwconv = phase_channelwise(dev, copy_gbs)
    torch.cuda.empty_cache()

    args = cli_argv(tmp, dev, "bfloat16", X3D_BS, X3D_BS, "--size",
                    str(X3D_SIZE), network="x3d_m")
    exp, host, ce = experiment(args, dev, bs=X3D_BS)
    k1_args = [torch.from_numpy(np.ascontiguousarray(getattr(host, k)))
               .to(dev)
               for k in ("canvas", "y0", "y1", "wy", "x0", "x1", "wx")]
    k1 = {"shapes": []}
    for dt in (torch.float32, torch.bfloat16):
        row, want = k1_compare(k1_args, dt, f"x3d_m batch of {X3D_BS}")
        k1["shapes"].append(row)
    k1["max_abs_err"] = max(r["max_abs_err"] for r in k1["shapes"])
    for k in ("ms", "launch_ms", "plain_ms"):
        k1[k] = row[k]
    del k1_args
    zero_counts()
    batch = to_card(exp, host)
    m = exp.train_step(batch["x"], batch["z"], batch["label"],
                       batch["weight"], ce)
    torch.cuda.synchronize()
    launches = read_counts()
    say(f"[train_x3d] one step of {X3D_BS} x {CLIP_LEN}x{X3D_SIZE}x"
        f"{X3D_SIZE} through device_batch: loss {float(m['loss']):.5f}, "
        f"launches {launches}")
    check(math.isfinite(float(m["loss"])), f"x3d_m's loss {m['loss']}")
    check(launches == expect(1, 84, 84, channelwise=27),
          f"train_x3d: launches {launches}, want 84 of each BN op and 27 "
          f"of each channel-wise kernel")
    dwconv["trace"] = traced_x3d_in_child(tmp)
    dwconv["trace_ms"] = dwconv["trace"]["channelwise_ms"]
    check(tuple(batch["x"].shape) == (X3D_BS, 1, CLIP_LEN, X3D_SIZE,
                                      X3D_SIZE, 3)
          and batch["x"].dtype == torch.bfloat16, "x3d_m batch shape")
    ulps = bf16_ulps(batch["x"].reshape(want.shape), want)
    check(ulps <= 1.0, f"device_batch's bf16 clips are {ulps} ulp from the "
                       f"plain transform of the same host batch")
    say(f"[K1] x3d_m batch of {X3D_BS} -> bfloat16 (device_batch's output "
        f"within {ulps:.2f} ulp of the plain transform): "
        + bound(k1, row["bytes"], row["flops"], copy_gbs))
    del want
    from zeroshotvideoclassification_tpu_torch.utils import profiler

    profiler.reset()
    timed = timed_steps(exp, batch, ce, smi, "train_x3d", clips=X3D_BS,
                        size=X3D_SIZE)
    exp.log.close()
    # where the host's time of an untraced step goes: each span's host ms
    # per train step (the spans are always counted)
    spans = profiler.summary()
    steps = spans["train.step"]["count"]
    timed["host_ms_per_step"] = {k: v["total_ms"] / steps
                                 for k, v in sorted(spans.items())}
    say(f"[train_x3d] host ms a step by span, untraced, over {steps} steps: "
        + ", ".join(f"{k} {v:.2f}"
                    for k, v in timed["host_ms_per_step"].items()))
    RECORD["train_x3d"] = {"launches": launches, **timed}
    RECORD["k1_x3d"] = k1
    return launches, k1, k2f, k2b, stats, dwconv


def traced_x3d_in_child(tmp):
    """traced_x3d_step in a spawned process of its own (a second
    torch.profiler session in one process drops kernels, and K4's trace
    comes last), on one host batch of X3D_BS clips after two warm-up
    steps. -> its record."""
    import multiprocessing

    path = os.path.join(tmp, "x3d_trace.json")
    proc = multiprocessing.get_context("spawn").Process(
        target=x3d_trace_entry, args=(os.path.join(tmp, "x3d_trace"), path))
    proc.start()
    proc.join(900)
    check(proc.exitcode == 0, f"the traced X3D-M step exited "
                              f"{proc.exitcode}")
    with open(path) as f:
        return json.load(f)


def x3d_trace_entry(tmp, path):
    """The spawned process of traced_x3d_in_child: its record to `path`."""
    import torch

    sys.path.insert(0, os.path.join(os.path.dirname(
        os.path.abspath(__file__)), "tests"))
    dev = torch.device(DEVICE)
    args = cli_argv(tmp, dev, "bfloat16", X3D_BS, X3D_BS, "--size",
                    str(X3D_SIZE), network="x3d_m")
    exp, host, ce = experiment(args, dev, bs=X3D_BS)
    batch = to_card(exp, host)
    for _ in range(2):  # cuDNN's algorithm timing off the trace
        exp.train_step(batch["x"], batch["z"], batch["label"],
                       batch["weight"], ce)
    out = traced_x3d_step(exp, batch, ce)
    exp.log.close()
    with open(path, "w") as f:
        json.dump(out, f)


def traced_x3d_step(exp, batch, ce):
    """One X3D-M train step under torch.profiler: the device ms of its
    channel-wise kernels (forward and data gradient are the gather kernel,
    the weight gradient its two kernels) and of cuDNN's, every kernel name
    that says `grouped` (cuDNN's grouped convs: none may be left), and the
    step's device ms by kind of kernel."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        exp.train_step(batch["x"], batch["z"], batch["label"],
                       batch["weight"], ce)
        torch.cuda.synchronize()
    kernels = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            k = kernels.setdefault(e.name, [0, 0.0])
            k[0] += 1
            k[1] += e.device_time_total / 1e3
    counts = {kind: sum(n for name, (n, _) in kernels.items() if kind in name)
              for kind in ("channelwise_gather_kernel",
                           "channelwise_wgrad_kernel",
                           "channelwise_wgrad_reduce_kernel")}
    out = {"kernels_counted": counts,
           "channelwise_ms": sum(ms for name, (_, ms) in kernels.items()
                                 if "channelwise" in name),
           "grouped": sorted(name for name in kernels if "grouped" in name),
           "device_ms": sum(ms for _, ms in kernels.values()),
           "top": sorted(((round(ms, 3), n, name[:90])
                          for name, (n, ms) in kernels.items()),
                         reverse=True)[:12]}
    say(f"[train_x3d] a traced step: {json.dumps(out)}")
    check(counts == {"channelwise_gather_kernel": 54,
                     "channelwise_wgrad_kernel": 27,
                     "channelwise_wgrad_reduce_kernel": 27},
          f"train_x3d: channel-wise kernels in the trace {counts}")
    check(not out["grouped"], f"train_x3d: cuDNN grouped kernels are left: "
                              f"{out['grouped']}")
    return out


def phase_channelwise(dev, copy_gbs, clips=X3D_BS, size=X3D_SIZE):
    """15b: X3D-M's 27 channel-wise convs at `clips` clips of CLIP_LEN x
    `size` x `size` (9 shapes): each kernel (forward, data gradient, weight
    gradient) against its plain version in bf16, the weight gradient's bits
    from two calls, then each timed beside its bound (three passes, every
    operand once), the plain version and cuDNN's channels-last call of the
    same conv through autograd (`library_ms`: forward and both gradients).
    -> the record, times per train step."""
    import torch
    import torch.nn.functional as F

    from torch_helpers import x3d_channelwise_shapes
    from zeroshotvideoclassification_tpu_torch.ops.channelwise_conv import (
        channelwise_dgrad_cuda,
        channelwise_dgrad_plain,
        channelwise_fwd_cuda,
        channelwise_fwd_plain,
        channelwise_wgrad_cuda,
        channelwise_wgrad_plain,
        output_shape,
    )

    per_shape = {}
    for shape in x3d_channelwise_shapes(clips, CLIP_LEN, size):
        per_shape[shape] = per_shape.get(shape, 0) + 1
    check(sum(per_shape.values()) == 27, f"x3d_m's convs {per_shape}")
    keys = ("fwd_ms", "dgrad_ms", "wgrad_ms", "plain_ms", "library_ms")
    out = {"clips": clips, "shapes": [], "ms": 0.0, "bytes": 0, "flops": 0,
           "max_ulps": 0.0, **{k: 0.0 for k in keys}}
    g = torch.Generator(device=dev).manual_seed(3)
    cl = torch.channels_last_3d
    for (xs, k, s, p), n in per_shape.items():
        what = f"channel-wise {'x'.join(map(str, xs))} k{k} s{s}"
        x = torch.randn(xs, device=dev, generator=g).to(torch.bfloat16,
                                                        memory_format=cl)
        w = torch.randn(xs[1], 1, *k, device=dev, generator=g) / math.sqrt(
            math.prod(k))
        ys = output_shape(xs, w.shape, s, p)
        dy = torch.randn(ys, device=dev, generator=g).to(torch.bfloat16,
                                                         memory_format=cl)
        y = channelwise_fwd_cuda(x, w, s, p)
        dx = channelwise_dgrad_cuda(dy, w, xs, s, p)
        dw = channelwise_wgrad_cuda(x, dy, w.shape, s, p)
        check(torch.equal(dw, channelwise_wgrad_cuda(x, dy, w.shape, s, p)),
              f"{what}: two weight gradients differ")
        ulps = []
        for got, want, scale in (
                (y, channelwise_fwd_plain(x, w, s, p),
                 channelwise_fwd_plain(x.abs(), w.abs(), s, p)),
                (dx, channelwise_dgrad_plain(dy, w, xs, s, p, x.dtype),
                 channelwise_dgrad_plain(dy.abs(), w.abs(), xs, s, p,
                                         x.dtype))):
            want = want.float()
            ulp = torch.exp2(torch.floor(torch.log2(torch.clamp_min(
                want.abs(), 2.0 ** -126))) - 7)
            # one rounding of float32 sums: an ulp, or the sums' own error
            # where the products cancel
            err = ((got.float() - want).abs() - 1e-5 * scale.float()) / ulp
            ulps.append(float(err.max()))
            del want, ulp, err, scale
        want = channelwise_wgrad_plain(x, dy, w.shape, s, p)
        scale = channelwise_wgrad_plain(x.abs(), dy.abs(), w.shape, s, p)
        wrel = float(((dw - want).abs() / scale.clamp_min(1e-30)).max())
        check(max(ulps) <= 1.0 and wrel <= 2e-5,
              f"{what}: y / dx {ulps} ulp, dW {wrel:.3g} of its sums")
        del y, dx, dw, want, scale
        torch.cuda.synchronize()
        wb = w.to(torch.bfloat16)

        def library():
            xr = x.detach().requires_grad_(True)
            wr = wb.detach().requires_grad_(True)
            yl = F.conv3d(xr, wr, None, s, p, 1, xs[1])
            torch.autograd.grad(yl, (xr, wr), dy)

        def plain():
            channelwise_fwd_plain(x, w, s, p)
            channelwise_dgrad_plain(dy, w, xs, s, p, x.dtype)
            channelwise_wgrad_plain(x, dy, w.shape, s, p)

        with torch.enable_grad():
            t = {"fwd_ms": time_ms(lambda: channelwise_fwd_cuda(x, w, s, p)),
                 "dgrad_ms": time_ms(
                     lambda: channelwise_dgrad_cuda(dy, w, xs, s, p)),
                 "wgrad_ms": time_ms(
                     lambda: channelwise_wgrad_cuda(x, dy, w.shape, s, p)),
                 "plain_ms": time_ms(plain, reps=3),
                 "library_ms": time_ms(library, reps=3)}
        # every operand once in each pass, bf16: (x, y), (dy, dx), (x, dy);
        # 27 (or 5) multiply-adds an output in each
        by = 3 * 2 * (x.numel() + math.prod(ys))
        fl = 3 * 2 * math.prod(k) * math.prod(ys)
        ms = t["fwd_ms"] + t["dgrad_ms"] + t["wgrad_ms"]
        for key in keys:
            out[key] += n * t[key]
        out["ms"] += n * ms
        out["bytes"] += n * by
        out["flops"] += n * fl
        out["max_ulps"] = max(out["max_ulps"], *ulps)
        out["shapes"].append({"x": list(xs), "kernel": list(k),
                              "stride": list(s), "calls": n, "ulps": ulps,
                              "wgrad_rel": wrel, **t,
                              "GB_per_s": by / 1e9 / (ms / 1e3)})
        say(f"[{what}] x{n}: y / dx within {max(ulps):.2f} ulp, dW "
            f"{wrel:.2g} of its sums, bits equal twice; forward "
            f"{t['fwd_ms']:.3f} ms, data gradient {t['dgrad_ms']:.3f}, "
            f"weight gradient {t['wgrad_ms']:.3f} "
            f"({by / 1e9 / (ms / 1e3):.0f} GB/s over the three); plain "
            f"{t['plain_ms']:.2f} ms, cuDNN channels-last "
            f"{t['library_ms']:.2f} ms")
        del x, w, wb, dy
        torch.cuda.empty_cache()
    text = bound(out, out["bytes"], out["flops"], copy_gbs)
    say(f"[channelwise] per bf16 train step at {clips} clips: kernels "
        f"{out['ms']:.3f} ms (forward {out['fwd_ms']:.3f}, data gradient "
        f"{out['dgrad_ms']:.3f}, weight gradient {out['wgrad_ms']:.3f}), "
        f"{100 * out['bound_ms'] / out['ms']:.1f}% of the bound; plain "
        f"{out['plain_ms']:.2f} ms, cuDNN channels-last "
        f"{out['library_ms']:.2f} ms; " + text)
    out["max_abs_err"] = out["max_ulps"]
    RECORD["channelwise_x3d"] = out
    return out


def phase_remat(tmp, dev, smi):
    """--remat full and --remat convs on r2plus1d_18 at 16 clips: through
    the training CLI (the recomputed blocks launch their 35 epilogues and
    BN statistics again: 72 K2 forward, 37 K2 backward, 72 sums and
    moments, 37 of each gradient, 1 K1 a step; the evaluation does not
    rematerialise); timed bf16 steps and peak memory of each beside the
    plain step, one Experiment at a time; and one float32 step of each on
    the same batch from the same init: loss within rtol 1e-4 of the plain
    step's, the BN running statistics moved once (as far as the plain
    step moved them, and every num_batches_tracked 1). -> launches by
    remat."""
    import torch

    launches = {}
    for remat in REMATS:
        args = cli_argv(tmp, dev, "bfloat16", TRAIN_BS, TRAIN_BS * P8_STEPS,
                        "--remat", remat)
        _, launches[remat], _ = cli_epoch(args, f"train_remat_{remat}", expect(
            P8_STEPS + 1, 72 * P8_STEPS + 37, 37 * P8_STEPS,
            sums=72 * P8_STEPS))
    timed, f32 = {}, {}
    for remat in ("none",) + REMATS:
        flags = () if remat == "none" else ("--remat", remat)
        torch.cuda.empty_cache()
        exp, host, ce = experiment(cli_argv(
            tmp, dev, "bfloat16", TRAIN_BS, TRAIN_BS, *flags), dev)
        timed[remat] = timed_steps(exp, to_card(exp, host), ce, smi,
                                   f"remat {remat}")
        exp.log.close()
        del exp
        torch.cuda.empty_cache()
        exp, host, ce = experiment(cli_argv(
            tmp, dev, "float32", TRAIN_BS, TRAIN_BS, *flags), dev)
        stats0 = bn_running(exp.model).clone()
        b = to_card(exp, host)
        loss = float(exp.train_step(b["x"], b["z"], b["label"], b["weight"],
                                    ce)["loss"])
        tracked = {int(v) for k, v in exp.model.state_dict().items()
                   if k.endswith("num_batches_tracked")}
        f32[remat] = (loss, bn_running(exp.model) - stats0, tracked)
        exp.log.close()
        del exp, b
    loss0, move0, _ = f32["none"]
    out = {"launches": launches, "timed": timed, "f32": {}}
    for remat in REMATS:
        loss, move, tracked = f32[remat]
        rel = abs(loss - loss0) / abs(loss0)
        off = float((move - move0).abs().max())
        say(f"[remat {remat}] float32 step of {TRAIN_BS} clips: loss "
            f"{loss} vs {loss0} without remat (rel {rel:.2g}, bar 1e-4); "
            f"running statistics moved as the plain step's within "
            f"{off:.3g} (its move up to {float(move0.abs().max()):.3g}), "
            f"num_batches_tracked {sorted(tracked)}; bf16 step "
            f"{timed[remat]['step_event_ms']:.2f} ms by events, peak "
            f"{timed[remat]['peak_GiB']:.2f} GiB (no remat "
            f"{timed['none']['step_event_ms']:.2f} ms, "
            f"{timed['none']['peak_GiB']:.2f} GiB)  ({smi})")
        check(rel <= 1e-4, f"remat {remat}: f32 loss {loss} vs {loss0}")
        check(tracked == {1} and off <= 1e-3 * float(move0.abs().max()),
              f"remat {remat}: running statistics moved {off} off the "
              f"plain step's, num_batches_tracked {tracked}")
        out["f32"][remat] = {"loss_rel": rel, "running_stats_max_abs": off}
    RECORD["remat"] = out
    return launches


def phase_fixconvs(tmp, dev):
    """One --fixconvs step (r2plus1d_18, bf16, 16 clips): 37 K2 forward
    epilogues and BN statistics, no K2 backward and no statistics'
    gradients, one K1; the backbone's parameters bit-equal
    and without gradients, the head's moved, the BN running statistics
    moved. -> launches."""
    import torch

    exp, host, ce = experiment(cli_argv(tmp, dev, "bfloat16", TRAIN_BS,
                                        TRAIN_BS, "--fixconvs"), dev)
    before = {k: v.detach().clone() for k, v in exp.model.state_dict().items()}
    zero_counts()
    b = to_card(exp, host)
    loss = float(exp.train_step(b["x"], b["z"], b["label"], b["weight"],
                                ce)["loss"])
    torch.cuda.synchronize()
    launches = read_counts()
    after = exp.model.state_dict()
    params = dict(exp.model.named_parameters())
    frozen = [k for k in params if k.startswith("model.")]
    check(all(torch.equal(after[k], before[k]) and params[k].grad is None
              for k in frozen), "--fixconvs moved a backbone parameter")
    check(all(not torch.equal(after[k], before[k]) for k in params
              if k not in frozen), "--fixconvs: the head did not move")
    moved = max(float((after[k] - before[k]).abs().max()) for k in after
                if "running" in k)
    check(moved > 1e-3, f"--fixconvs: BN running statistics moved {moved}")
    check(launches == expect(1, 37, 0, sums=37),
          f"--fixconvs launches {launches}")
    say(f"[train_fixconvs] one step, loss {loss:.5f}: {len(frozen)} backbone "
        f"parameters bit-equal, {len(params) - len(frozen)} head parameters "
        f"moved, BN running statistics moved by up to {moved:.3g}; "
        f"launches {launches}")
    exp.log.close()
    RECORD["train_fixconvs"] = {"launches": launches, "loss": loss}
    return launches


# ------------------ data parallelism across processes (phases 16-18) ----

DP_LOCAL = TRAIN_BS // 2   # clips a process steps on in phases 17 and 18
DP_WARMUP, DP_TIMED = 2, 3  # bf16 steps before and in the timing
DP_SPAWN_TIMEOUT = 480     # seconds for the processes of one phase


def host_rows(host, rows):
    """The samples `rows` (a slice) of a host batch."""
    import dataclasses

    return dataclasses.replace(host, **{
        k: getattr(host, k)[rows] for k in ("canvas", "y0", "y1", "wy", "x0",
                                            "x1", "wx", "z", "label",
                                            "weight")})


def f32_steps(args, dev, rows):
    """Two float32 steps of the Experiment of `args` (a seeded non-zero Adam
    state) on the clips `rows` of its first host batch of TRAIN_BS clips
    (read as one process reads it). -> (losses, parameters on the CPU)."""
    from torch_helpers import seed_adam

    exp, host, ce = experiment(args, dev)
    seed_adam(exp.optimizer, exp.model, seed=3, count=1000)
    b = to_card(exp, host_rows(host, rows))
    losses = [float(exp.train_step(b["x"], b["z"], b["label"], b["weight"],
                                   ce)["loss"]) for _ in range(2)]
    params = {k: v.detach().cpu().clone()
              for k, v in exp.model.named_parameters()}
    exp.log.close()
    return losses, params


def dp_timed_steps(args, dev, rows):
    """The bf16 Experiment of `args` on the clips `rows` of its first host
    batch: the kernels' launches counted over one K1 (the batch) and
    DP_WARMUP + DP_TIMED steps; the timed steps each between two CUDA events
    and by the host's clock around a synchronise. -> (record, exp, batch,
    class embeddings)."""
    import torch

    exp, host, ce = experiment(args, dev)
    zero_counts()
    b = to_card(exp, host_rows(host, rows))
    ev, wall, losses = [], [], []
    for i in range(DP_WARMUP + DP_TIMED):
        torch.cuda.synchronize()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        e0.record()
        m = exp.train_step(b["x"], b["z"], b["label"], b["weight"], ce)
        e1.record()
        torch.cuda.synchronize()
        if i >= DP_WARMUP:
            wall.append((time.perf_counter() - t0) * 1e3)
            ev.append(e0.elapsed_time(e1))
        losses.append(float(m["loss"]))
    launches = read_counts()
    check(all(math.isfinite(v) for v in losses), f"losses {losses}")
    return ({"event_ms": statistics.median(ev), "host_ms":
             statistics.median(wall), "event_ms_all": ev, "host_ms_all": wall,
             "losses": losses, "launches": launches}, exp, b, ce)


def nccl_step_trace(exp, b, ce):
    """One train step in a torch.profiler trace: the device time of the NCCL
    kernels and of all kernels, and the number of c10d all-reduce calls the
    host made. -> dict."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    exp.train_step(b["x"], b["z"], b["label"], b["weight"], ce)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        exp.train_step(b["x"], b["z"], b["label"], b["weight"], ce)
        torch.cuda.synchronize()
    events = prof.events()
    dev_kernels = [e for e in events
                   if e.device_type == torch.autograd.DeviceType.CUDA]
    nccl = [e for e in dev_kernels if "nccl" in e.name.lower()]
    calls = [e for e in events
             if e.device_type == torch.autograd.DeviceType.CPU
             and e.name.lower() in ("nccl:all_reduce", "c10d::allreduce_")]
    return {"nccl_kernels": len(nccl),
            "nccl_ms": sum(e.time_range.elapsed_us() for e in nccl) / 1e3,
            "device_ms": sum(e.time_range.elapsed_us()
                             for e in dev_kernels) / 1e3,
            "allreduce_calls": len([e for e in calls
                                    if e.name.lower() == "nccl:all_reduce"]),
            "c10d_calls": len([e for e in calls
                               if e.name.lower() == "c10d::allreduce_"])}


def dp_world1_job(rank, world, dev, out_dir, join):
    """Phase 16 in its own process (its trace is then not the main
    process's: a second torch.profiler session in one process drops
    kernels, and K4's trace comes last there): the float32 steps and the
    timed bf16 steps without a group, then `join` (an NCCL group of one)
    and the same again, the launches counted in the group's run, and one
    step's collectives in a trace. The float32 parameters are saved
    beside."""
    import torch

    f32_args = cli_argv(out_dir, dev, "float32", TRAIN_BS, TRAIN_BS)
    bf_args = cli_argv(out_dir, dev, "bfloat16", TRAIN_BS, TRAIN_BS)
    rows = slice(0, TRAIN_BS)
    res = {}
    for tag in ("no_group", "group"):
        if tag == "group":
            join()
            res["backend"] = torch.distributed.get_backend()
        losses, params = f32_steps(f32_args, dev, rows)
        path = os.path.join(out_dir, f"params_{tag}.pt")
        torch.save(params, path)
        del params
        timed, exp, b, ce = dp_timed_steps(bf_args, dev, rows)
        res[tag] = {"losses": losses, "params": path, "timed": timed}
        if tag == "group":
            res["trace"] = nccl_step_trace(exp, b, ce)
        exp.log.close()
        del exp, b
        torch.cuda.empty_cache()
    return res


def phase_dp_world1(tmp, smi):
    """A process group of one rank under NCCL (r2plus1d_18, 16 clips of
    16x112x112), in one spawned process: two float32 steps against the
    same steps without a group (loss rtol 1e-4, parameters atol 2e-5; bit
    for bit reported), DP_TIMED bf16 steps timed with and without the
    group, the launches counted in the group's run, and one step's
    collectives in a trace. -> (launches, the ungrouped float32 steps'
    losses and parameters)."""
    import torch

    (r,) = spawn_ranks("world1", "nccl", tmp, world=1)
    check(r["backend"] == "nccl", f"backend {r['backend']}")
    plain, grp, trace = r["no_group"], r["group"], r["trace"]
    l_plain, l_grp = plain["losses"], grp["losses"]
    p_plain = torch.load(plain["params"], weights_only=True)
    p_grp = torch.load(grp["params"], weights_only=True)
    launches = grp["timed"]["launches"]
    steps = DP_WARMUP + DP_TIMED
    check(launches == expect(1, 37 * steps, 37 * steps),
          f"train_dp_world1 launches {launches}")
    bitwise = l_grp == l_plain and all(torch.equal(p_grp[k], p_plain[k])
                                       for k in p_plain)
    rel = max(abs(a - b) / abs(b) for a, b in zip(l_grp, l_plain))
    dmax = max(float((p_grp[k] - p_plain[k]).abs().max()) for k in p_plain)
    del p_grp
    say(f"[train_dp_world1] NCCL group of one, 2 float32 steps of "
        f"{TRAIN_BS} clips: losses {l_grp} vs {l_plain} without a group "
        f"(rel {rel:.2g}, bar 1e-4), parameters {dmax:.3g} apart (bar "
        f"2e-5), bit for bit: {bitwise}")
    check(rel <= 1e-4 and dmax <= 2e-5,
          f"train_dp_world1: f32 steps off the ungrouped ones: {rel}, {dmax}")
    g, n = grp["timed"], plain["timed"]
    say(f"[train_dp_world1] bf16 step of {TRAIN_BS} clips: "
        f"{g['event_ms']:.2f} ms by CUDA events, {g['host_ms']:.2f} ms by "
        f"the host's clock in the group; {n['event_ms']:.2f} / "
        f"{n['host_ms']:.2f} ms without (medians of {DP_TIMED} steps after "
        f"{DP_WARMUP}); one step's trace: {trace['allreduce_calls']} NCCL "
        f"all-reduce calls ({trace['c10d_calls']} c10d), "
        f"{trace['nccl_kernels']} NCCL kernels, {trace['nccl_ms']:.3f} ms of "
        f"NCCL device time of {trace['device_ms']:.2f} ms; launches "
        f"{launches}  ({smi})")
    RECORD["train_dp_world1"] = {
        "f32": {"loss_rel": rel, "param_max_abs": dmax, "bitwise": bitwise},
        "group": g, "no_group": n, "trace": trace}
    return launches, (l_plain, p_plain)


def dp_rank_entry(rank, world, backend, store, out_dir, job):
    """One spawned process of phase 16, 17 or 18 (gloo: every process on
    cuda:0; NCCL: cuda:<rank>): runs `job`, which joins the group when it
    calls the function it is given, and saves its result."""
    import torch

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(
        __file__)), "tests"))
    from zeroshotvideoclassification_tpu_torch.parallel import (
        maybe_initialize,
    )

    dev = torch.device("cuda", 0 if backend == "gloo" else rank)

    def join():
        maybe_initialize(backend=backend, init_method=f"file://{store}",
                         rank=rank, world_size=world, device=dev)

    try:
        res = {"world1": dp_world1_job, "step": dp_step_job,
               "cli": dp_cli_job, "graphs": graphs_nccl_job,
               "graphs_timed": graphs_timed_job, "tp_step": tp_step_job,
               "tp_cli": tp_cli_job, "graphs_tp": graphs_tp_job}[job](
                   rank, world, dev, out_dir, join)
        torch.save(res, os.path.join(out_dir, f"{job}_{rank}.pt"))
    finally:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()


def spawn_ranks(job, backend, tmp, world=2):
    """Run dp_rank_entry(job) in `world` spawned processes, at most
    DP_SPAWN_TIMEOUT seconds; every process is stopped before this returns
    or raises. -> their results, by rank."""
    import torch
    import torch.multiprocessing as mp

    out_dir = os.path.join(tmp, f"dp_{job}")
    os.makedirs(out_dir, exist_ok=True)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    ctx = mp.start_processes(
        dp_rank_entry, args=(world, backend, os.path.join(out_dir, "store"),
                             out_dir, job),
        nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + DP_SPAWN_TIMEOUT
    try:
        while not ctx.join(timeout=5):
            check(time.monotonic() < deadline,
                  f"{job}: the processes did not end in {DP_SPAWN_TIMEOUT} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join(30)
    return [torch.load(os.path.join(out_dir, f"{job}_{r}.pt"),
                       weights_only=False) for r in range(world)]


def dp_step_job(rank, world, dev, out_dir, join):
    """Phase 17 in one process: the two float32 steps on its DP_LOCAL clips
    of phase 16's batch (parameters saved beside), then the timed bf16
    steps with the launches counted."""
    import torch

    join()
    rows = slice(rank * DP_LOCAL, (rank + 1) * DP_LOCAL)
    losses, params = f32_steps(cli_argv(out_dir, dev, "float32", DP_LOCAL,
                                        TRAIN_BS), dev, rows)
    path = os.path.join(out_dir, f"params_{rank}.pt")
    torch.save(params, path)
    timed, exp, _, _ = dp_timed_steps(
        cli_argv(out_dir, dev, "bfloat16", DP_LOCAL, TRAIN_BS), dev, rows)
    exp.log.close()
    return {"losses": losses, "params": path, "timed": timed,
            "backend": torch.distributed.get_backend()}


def dp_cli_job(rank, world, dev, out_dir, join):
    """Phase 18 in one process: one epoch of cli.main (global batch
    TRAIN_BS, 2 steps, the evaluation, --checkpoint_every 1) with the
    launches counted and every file this process opens to write under the
    save path recorded."""
    return cli_job(dev, out_dir, join, cli_argv(
        out_dir, dev, "bfloat16", DP_LOCAL, 2 * TRAIN_BS,
        "--checkpoint_every", "1"))


def cli_job(dev, out_dir, join, args):
    """cli.main with `args` in this process of a group, the launches
    counted and every file it opens to write under the save path
    recorded."""
    import torch

    join()
    from zeroshotvideoclassification_tpu_torch.cli import main as train_cli

    root = os.path.realpath(os.path.join(out_dir, "runs"))
    writes = []

    def audit(event, a):
        if event == "open":
            paths = [a[0]] if (any(c in (a[1] or "") for c in "wax+") or (
                a[2] or 0) & (os.O_WRONLY | os.O_RDWR | os.O_CREAT)) else []
        elif event == "os.mkdir":
            paths = [a[0]]
        elif event in ("os.rename", "os.replace"):
            paths = [a[0], a[1]]
        else:
            return
        for path in paths:
            if (isinstance(path, str)
                    and os.path.realpath(path).startswith(root)):
                writes.append(os.path.relpath(os.path.realpath(path), root))

    sys.addaudithook(audit)
    zero_counts()
    t0 = time.perf_counter()
    summary = train_cli.main(args)
    torch.cuda.synchronize()
    return {"summary": summary, "launches": read_counts(),
            "seconds": time.perf_counter() - t0, "writes": writes,
            "root": root}


def phase_dp_2rank(tmp, dev, smi, f32_plain):
    """Two processes, DP_LOCAL clips each (global batch TRAIN_BS): NCCL on
    two GPUs where the host shows two, else gloo with both on cuda:0 (NCCL
    refuses two processes on one device). Two float32 steps against phase
    16's one process on the whole batch (loss rtol 1e-4, parameters atol
    2e-5), parameters bit-equal across the processes, and the bf16 steps'
    launches (one K1, 37 K2 forward and 37 K2 backward a step) and time.
    -> (backend, rank 0's launches)."""
    import torch

    backend = "nccl" if torch.cuda.device_count() >= 2 else "gloo"
    t0 = time.perf_counter()
    rs = spawn_ranks("step", backend, tmp)
    wall = time.perf_counter() - t0
    l_one, p_one = f32_plain
    params = [torch.load(r["params"], weights_only=True) for r in rs]
    check(all(r["backend"] == backend for r in rs), "backend")
    check(rs[0]["losses"] == rs[1]["losses"], f"ranks' losses "
          f"{[r['losses'] for r in rs]}")
    same = all(torch.equal(params[0][k], params[1][k]) for k in params[0])
    check(same, "train_dp_2rank: parameters differ across the processes")
    rel = max(abs(a - b) / abs(b) for a, b in zip(rs[0]["losses"], l_one))
    dmax = max(float((params[0][k] - p_one[k]).abs().max()) for k in p_one)
    steps = DP_WARMUP + DP_TIMED
    for r in rs:
        check(r["timed"]["launches"] == expect(1, 37 * steps, 37 * steps),
              f"train_dp_2rank launches {r['timed']['launches']}")
    say(f"[train_dp_2rank] {backend}, 2 processes "
        f"{'on cuda:0 and cuda:1' if backend == 'nccl' else 'both on cuda:0'}"
        f", {DP_LOCAL} clips each: 2 float32 steps, losses "
        f"{rs[0]['losses']} vs {l_one} of one process on {TRAIN_BS} (rel "
        f"{rel:.2g}, bar 1e-4), parameters {dmax:.3g} apart (bar 2e-5), bit-"
        f"equal across the processes; launches a process "
        f"{rs[0]['timed']['launches']} over {steps} steps")
    check(rel <= 1e-4 and dmax <= 2e-5,
          f"train_dp_2rank against one process: {rel}, {dmax}")
    say(f"[train_dp_2rank] bf16 step of {DP_LOCAL} clips a process: "
        f"{[round(r['timed']['event_ms'], 2) for r in rs]} ms by CUDA events, "
        f"{[round(r['timed']['host_ms'], 2) for r in rs]} ms by the host's "
        f"clock (processes 0, 1; medians of {DP_TIMED}); "
        + ("both processes share one GPU under gloo: a correctness run, not "
           "a scaling figure" if backend == "gloo" else "one GPU each")
        + f"; the phase {wall:.1f} s  ({smi})")
    RECORD["train_dp_2rank"] = {
        "backend": backend, "loss_rel": rel, "param_max_abs": dmax,
        "timed": [r["timed"] for r in rs], "seconds": wall}
    return backend, rs[0]["timed"]["launches"]


def phase_dp_cli(tmp, dev, smi):
    """cli.main on two processes (as phase 17): one epoch of 2 steps of
    TRAIN_BS clips, the evaluation, --checkpoint_every 1. Both report the
    same metrics; process 1 opens no file to write under the save path; a
    one-process --evaluate of process 0's checkpoint gives its test
    accuracy. -> rank 0's launches."""
    import glob

    import torch

    from zeroshotvideoclassification_tpu_torch.cli import main as train_cli

    backend = "nccl" if torch.cuda.device_count() >= 2 else "gloo"
    rs = spawn_ranks("cli", backend, tmp)
    keys = ("loss", "train_accuracy", "synthetic_test_accuracy",
            "best_accuracy")
    check(all(rs[0]["summary"][k] == rs[1]["summary"][k] for k in keys),
          f"cli_dp_2rank summaries {[r['summary'] for r in rs]}")
    check(rs[1]["writes"] == [], f"process 1 wrote {rs[1]['writes']}")
    check(any(w.endswith("last.npz") for w in rs[0]["writes"]),
          f"process 0 wrote {rs[0]['writes']}")
    for r in rs:  # 2 steps and one evaluation dispatch of 8 videos each
        check(r["launches"] == expect(3, 37 * 3, 37 * 2),
              f"cli_dp_2rank launches {r['launches']}")
    run = os.path.dirname(glob.glob(os.path.join(rs[0]["root"], "**",
                                                 "last.npz"),
                                    recursive=True)[0])
    ckpt = os.path.join(run, "checkpoint.npz")
    if not os.path.exists(ckpt):  # accuracy 0: no best checkpoint
        ckpt = os.path.join(run, "last.npz")
    acc = train_cli.main(cli_argv(os.path.join(tmp, "dp_eval"), dev,
                                  "bfloat16", TRAIN_BS, 2 * TRAIN_BS,
                                  "--evaluate", "--weights", ckpt))
    torch.cuda.synchronize()
    want = rs[0]["summary"]["synthetic_test_accuracy"]
    say(f"[cli_dp_2rank] {backend}: cli.main on 2 processes in "
        f"{rs[0]['seconds']:.1f} s: loss {rs[0]['summary']['loss']:.5f}, "
        f"test accuracy {want:.1f} on both; process 0 wrote "
        f"{len(rs[0]['writes'])} files, process 1 none; launches a process "
        f"{rs[0]['launches']}; --evaluate of {os.path.basename(ckpt)} on one "
        f"process: {acc['synthetic_test_accuracy']:.1f}  ({smi})")
    check(acc["synthetic_test_accuracy"] == want,
          f"--evaluate of process 0's checkpoint: {acc} vs {want}")
    RECORD["cli_dp_2rank"] = {"backend": backend,
                              "summaries": [r["summary"] for r in rs],
                              "launches": [r["launches"] for r in rs],
                              "writes_rank0": rs[0]["writes"],
                              "evaluate": acc}
    return rs[0]["launches"]


def phase_dp_kernels(tmp, dev, copy_gbs):
    """K1 and K2 forward and backward against their plain versions at the
    shapes of a process of phases 17 and 18 (DP_LOCAL clips of the
    training table's first batch). -> (K1's record, K2 backward's, K2
    forward's)."""
    import numpy as np
    import torch

    from zeroshotvideoclassification_tpu_torch.cli import main as train_cli
    from zeroshotvideoclassification_tpu_torch.cli.infer import load_model
    from zeroshotvideoclassification_tpu_torch.config import (
        Config,
        config_from_namespace,
    )
    from zeroshotvideoclassification_tpu_torch.data.datasets import (
        build_datasets,
    )
    from zeroshotvideoclassification_tpu_torch.data.pipeline import (
        HostPipeline,
    )

    cfg = config_from_namespace(train_cli.build_arg_parser().parse_args(
        cli_argv(tmp, dev, "bfloat16", DP_LOCAL, TRAIN_BS)))
    table = build_datasets(cfg, None)["training"][0]
    host = next(iter(HostPipeline(table, cfg, TRAIN_BS, seed=cfg.seed)))
    local = host_rows(host, slice(0, DP_LOCAL))
    args = [torch.from_numpy(np.ascontiguousarray(getattr(local, k))).to(dev)
            for k in ("canvas", "y0", "y1", "wy", "x0", "x1", "wx")]
    k1 = {"shapes": []}
    for dt in (torch.float32, torch.bfloat16):
        row, _ = k1_compare(args, dt, f"a process's shard of {DP_LOCAL}")
        k1["shapes"].append(row)
    k1["max_abs_err"] = max(r["max_abs_err"] for r in k1["shapes"])
    for k in ("ms", "launch_ms", "plain_ms"):
        k1[k] = row[k]
    say(f"[K1] shard of {DP_LOCAL} -> bfloat16: "
        + bound(k1, row["bytes"], row["flops"], copy_gbs))
    RECORD["k1_dp"] = k1
    m, _ = load_model(Config(size=SIZE, clip_len=CLIP_LEN,
                             compute_dtype="float32"), None, dev)
    calls = epilogue_calls(m, torch.zeros(
        (DP_LOCAL, 1, CLIP_LEN, SIZE, SIZE, 3), device=dev))
    del m
    k2b, k2f = phase_k2_bwd(calls, dev, copy_gbs, key="_dp",
                            clips=DP_LOCAL)
    return k1, k2b, k2f


# ------------------- CUDA graphs of the train step (phase 19) ----

GRAPH_K = 4         # --steps_per_call of phase 19
GRAPH_TIMED = 5     # eager steps and replays timed (after the warm-up)
GRAPH_LR = "5e-4"   # lr 5e-4 over two epochs: epoch 1 at 5e-5 (multistep_lr)
GRAPH_CLIPS = 8     # float32 clips of the dropout, remat and NCCL checks
                    # (a process's, as DP_LOCAL: BN's late layers span
                    # enough positions for the f32 bars)
GRAPH_NODES = {"bn_apply_relu": ("bn_apply_relu_kernel",),
               "bn_apply_relu_bwd": ("bn_bwd_kernel", "bn_bwd_reduce_kernel"),
               "bn_sums": ("bn_sums_kernel", "bn_sums_reduce_kernel"),
               "bn_sums_grad": ("bn_sums_grad_kernel",),
               "bn_moments": ("bn_moments_kernel",),
               "bn_moments_grad": ("bn_moments_grad_kernel",)}


def release():
    """Free what the last Experiment held on the card: a scan step refers
    to itself through its closures, so its graphs and their pool go at the
    next garbage collection."""
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()


def graph_kernels(graph, path):
    """K2's and the BN statistics' kernel nodes in a captured CUDA graph,
    from its DOT dump (CUDAGraph.debug_dump): {"bn_apply_relu": forward
    kernels, "bn_apply_relu_bwd": backward kernels (pass 1 and pass 2),
    "bn_sums": the sums' kernels (both stages), "bn_sums_grad": their
    gradient's, "bn_moments", "bn_moments_grad": the moments' and their
    gradient's, "kernels": every kernel node}."""
    import re

    graph.debug_dump(path)
    with open(path) as f:
        # one chunk a node; a node's label spans several lines
        nodes = re.split(r'\n"graph_\d+_node_\d+"\[', f.read())[1:]
    kernels = [c for c in nodes if 'label="{KERNEL' in c]
    out = {name: sum(1 for c in kernels if any(k in c for k in ks))
           for name, ks in GRAPH_NODES.items()}
    out["kernels"] = len(kernels)
    return out


def recording(exp):
    """Keep the loss of every step `exp`'s trainer takes: wraps its scan
    step's run, or its single step. -> the list the losses go to."""
    losses = []
    if exp.scan_step is not None:
        run = exp.scan_step.run

        def rec_run(*a, **kw):
            m = run(*a, **kw)
            losses.extend(m["loss"].tolist())
            return m

        exp.scan_step.run = rec_run
    else:
        single = exp.train_step

        def rec(*a, **kw):
            m = single(*a, **kw)
            losses.append(float(m["loss"]))
            return m

        rec.state = single.state
        exp.train_step = rec
    return losses


def graph_parity(tmp, dev, samples, epochs, tag):
    """Experiment.run() (what cli.main runs) of `epochs` epochs of
    `samples` synthetic clips at --bs TRAIN_BS, float32, lr GRAPH_LR,
    from a seeded non-zero Adam state, at --steps_per_call GRAPH_K and at 1:
    every step's loss within rtol 1e-4, the parameters within atol 2e-5,
    bit-equality reported. -> (record, the K run's wrapper launches)."""
    import torch

    from torch_helpers import seed_adam
    from zeroshotvideoclassification_tpu_torch.train import multistep_lr

    runs = {}
    for k in (GRAPH_K, 1):
        args = cli_argv(tmp, dev, "float32", TRAIN_BS, samples,
                        "--steps_per_call", str(k), "--lr", GRAPH_LR,
                        "--n_epochs", str(epochs))
        exp, _, _ = experiment(args, dev)
        seed_adam(exp.optimizer, exp.model, seed=3, count=1000)
        losses = recording(exp)
        zero_counts()
        t0 = time.perf_counter()
        summary = exp.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        runs[k] = {"losses": losses, "summary": summary, "seconds": wall,
                   "launches": read_counts(),
                   "step": exp.train_step.state.step,
                   "count": int(exp.optimizer.count),
                   "lr": float(exp.optimizer.lr_tensors[0]),
                   "capture_s": (exp.scan_step.captured["seconds"]
                                 if exp.scan_step else None),
                   "params": {n: v.detach().clone() for n, v in
                              exp.model.named_parameters()}}
        exp.log.close()
        del exp
        release()
    g, e = runs[GRAPH_K], runs[1]
    steps = epochs * (-(-samples // TRAIN_BS))
    check(len(g["losses"]) == len(e["losses"]) == steps
          and g["step"] == e["step"] == steps
          and g["count"] == e["count"] == 1000 + steps,
          f"{tag}: steps {len(g['losses'])} / {len(e['losses'])}, state "
          f"{g['step']} / {e['step']}, Adam {g['count']} / {e['count']}")
    rel = max(abs(a - b) / abs(b) for a, b in zip(g["losses"], e["losses"]))
    dmax = max(float((g["params"][n] - e["params"][n]).abs().max())
               for n in e["params"])
    bitwise = g["losses"] == e["losses"] and all(
        torch.equal(g["params"][n], e["params"][n]) for n in e["params"])
    say(f"[{tag}] {epochs} epoch(s) of {steps // epochs} float32 steps of "
        f"{TRAIN_BS} clips through Experiment.run: --steps_per_call "
        f"{GRAPH_K} (capture {g['capture_s']:.2f} s, run {g['seconds']:.1f} "
        f"s) against 1 ({e['seconds']:.1f} s): losses rel {rel:.2g} (bar "
        f"1e-4), parameters {dmax:.3g} apart (bar 2e-5), bit for bit: "
        f"{bitwise}; last epoch's lr {g['lr']:.3g}; losses {g['losses']}")
    check(rel <= 1e-4 and dmax <= 2e-5,
          f"{tag}: grouped against single steps: {rel}, {dmax}")
    want_lr = multistep_lr(float(GRAPH_LR), epochs)(epochs - 1)
    check(abs(g["lr"] - want_lr) <= 1e-6 * want_lr,
          f"{tag}: the last epoch's lr tensor {g['lr']}, want {want_lr}")
    return ({"loss_rel": rel, "param_max_abs": dmax, "bitwise": bitwise,
             "steps": steps, "capture_s": g["capture_s"],
             "seconds": {"graphs": g["seconds"], "eager": e["seconds"]}},
            g["launches"])


def timed_calls(fn, n, per):
    """n calls of fn, each between two CUDA events and by the host's clock
    around a synchronise, then n queued back to back; every figure over
    `per` steps a call. -> dict of ms a step."""
    import torch

    ev, host = [], []
    for _ in range(n):
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        host.append((time.perf_counter() - t0) * 1e3 / per)
        ev.append(a.elapsed_time(b) / per)
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    a.record()
    for _ in range(n):
        fn()
    b.record()
    torch.cuda.synchronize()
    return {"event_ms": statistics.median(ev), "host_ms":
            statistics.median(host), "event_ms_all": ev, "host_ms_all": host,
            "queued_host_ms": (time.perf_counter() - t0) * 1e3 / (n * per),
            "queued_event_ms": a.elapsed_time(b) / (n * per)}


def graph_timing(tmp, dev, smi):
    """bf16, 16 clips, --steps_per_call GRAPH_K: the eager step and a
    replay / K timed in one process, peak memory of both, the capture's
    time; the K2 kernels one replay launches (37 K and 74 K); then a group
    of NaN batches: parameters, moments and Adam's count as they were.
    -> record."""
    import torch

    exp, host, ce = experiment(cli_argv(
        tmp, dev, "bfloat16", TRAIN_BS, TRAIN_BS, "--steps_per_call",
        str(GRAPH_K)), dev)
    scan = exp.scan_step
    b = to_card(exp, host)
    batch = (b["x"], b["z"], b["label"], b["weight"])
    rng = exp.rng.manual_seed(0)
    for _ in range(TRAIN_WARMUP):
        exp.train_step(*batch, ce, rng)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    eager = timed_calls(lambda: exp.train_step(*batch, ce, rng), GRAPH_TIMED,
                        1)
    eager["peak_GiB"] = torch.cuda.max_memory_allocated() / 2 ** 30
    torch.cuda.empty_cache()
    eager["reserved_GiB"] = torch.cuda.memory_reserved() / 2 ** 30
    for k in range(GRAPH_K):
        scan.stage(k, *batch)
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    scan.run(GRAPH_K, ce, rng)  # the first group: eager, then the capture
    torch.cuda.synchronize()
    first = read_counts()
    n = 37 * (2 * GRAPH_K + 1)  # K eager steps, K + 1 captured (not run)
    check(first == expect(0, n, n) and scan.graphs,
          f"the first group and the capture counted {first}, want {n}")
    graph = {"capture_s": scan.captured["seconds"],
             "first_group_peak_GiB": torch.cuda.max_memory_allocated()
             / 2 ** 30}
    torch.cuda.empty_cache()
    graph["reserved_GiB"] = torch.cuda.memory_reserved() / 2 ** 30
    zero_counts()
    graph.update(timed_calls(lambda: scan.run(GRAPH_K, ce, rng), GRAPH_TIMED,
                             GRAPH_K))
    check(read_counts() == expect(0, 0, 0), "a replay called a wrapper")
    nodes = graph_kernels(scan.graphs[GRAPH_K][0],
                          os.path.join(tmp, "graph.dot"))
    one = graph_kernels(scan.graphs[1][0], os.path.join(tmp, "graph1.dot"))
    graph.update(nodes=nodes, nodes_one_step=one)
    say(f"[train_graphs] bf16 step of {TRAIN_BS} clips: eager "
        f"{eager['event_ms']:.2f} ms by CUDA events, {eager['host_ms']:.2f} "
        f"ms by the host's clock (queued {eager['queued_event_ms']:.2f} / "
        f"{eager['queued_host_ms']:.2f}); a replay of {GRAPH_K} steps / "
        f"{GRAPH_K}: {graph['event_ms']:.2f} ms by events, "
        f"{graph['host_ms']:.2f} ms by the host's clock (queued "
        f"{graph['queued_event_ms']:.2f} / {graph['queued_host_ms']:.2f}); "
        f"medians of {GRAPH_TIMED}; capture {graph['capture_s']:.2f} s; "
        f"peak {eager['peak_GiB']:.2f} GiB eager (reserved "
        f"{eager['reserved_GiB']:.2f} after empty_cache), the first group "
        f"and its capture {graph['first_group_peak_GiB']:.2f} GiB, "
        f"reserved with the graphs {graph['reserved_GiB']:.2f} GiB; one "
        f"replay's kernel nodes {nodes}, the one-step graph's {one}  "
        f"({smi})")
    check(nodes["bn_apply_relu"] == 37 * GRAPH_K
          and nodes["bn_apply_relu_bwd"] == 74 * GRAPH_K,
          f"K2 kernels in one replay: {nodes}, want {37 * GRAPH_K} / "
          f"{74 * GRAPH_K}")
    check(one["bn_apply_relu"] == 37 and one["bn_apply_relu_bwd"] == 74,
          f"K2 kernels in the one-step graph: {one}")
    check(nodes["bn_sums"] == 74 * GRAPH_K
          and nodes["bn_sums_grad"] == nodes["bn_moments"]
          == nodes["bn_moments_grad"] == 37 * GRAPH_K
          and one["bn_sums"] == 74 and one["bn_sums_grad"] == one[
              "bn_moments"] == one["bn_moments_grad"] == 37,
          f"the BN statistics' kernels in one replay: {nodes}, in the "
          f"one-step graph: {one}; want the sums' two stages and one kernel "
          f"of each other a BN")

    # a group of NaN batches: the guard skips every step on the device
    opt = exp.optimizer
    params = {n: v.detach().clone() for n, v in exp.model.named_parameters()}
    moments = [(opt.state[p]["exp_avg"].clone(),
                opt.state[p]["exp_avg_sq"].clone())
               for p in exp.model.parameters()]
    count, skipped = int(opt.count), int(opt.total_notfinite)
    step0 = scan.state.step
    bad = torch.full_like(b["x"], float("nan"))
    for k in range(GRAPH_K):
        scan.stage(k, bad, *batch[1:])
    m = scan.run(GRAPH_K, ce, rng)
    torch.cuda.synchronize()
    check(not bool(m["finite"].any()) and not bool(
        torch.isfinite(m["loss"]).any()), f"NaN group's metrics {m}")
    check(all(torch.equal(v, params[n])
              for n, v in exp.model.named_parameters()),
          "a NaN group changed the parameters")
    check(all(torch.equal(opt.state[p]["exp_avg"], a)
              and torch.equal(opt.state[p]["exp_avg_sq"], v)
              for p, (a, v) in zip(exp.model.parameters(), moments)),
          "a NaN group changed Adam's moments")
    check(int(opt.count) == count
          and int(opt.total_notfinite) == skipped + GRAPH_K
          and scan.state.step == step0 + GRAPH_K,
          f"a NaN group: Adam count {int(opt.count)} (was {count}), skips "
          f"{int(opt.total_notfinite)} (was {skipped}), steps "
          f"{scan.state.step} (was {step0})")
    say(f"[train_graphs] a replay of {GRAPH_K} NaN batches: every step "
        f"skipped on the device (Adam's count stays {count}, "
        f"total_notfinite +{GRAPH_K}, the step count +{GRAPH_K}), "
        f"parameters and moments bit-equal")
    exp.log.close()
    return {"eager": eager, "graph": graph}


def debug_nans_epoch(tmp, dev, k, bad_step):
    """One epoch of 2 * GRAPH_K bf16 steps through the trainer with
    --debug_nans at --steps_per_call k, the batch of step `bad_step` NaN:
    FloatingPointError naming that step. -> its message."""
    import torch

    from zeroshotvideoclassification_tpu_torch.cli import main as train_cli

    exp, _, _ = experiment(cli_argv(
        tmp, dev, "bfloat16", TRAIN_BS, 2 * GRAPH_K * TRAIN_BS,
        "--steps_per_call", str(k), "--debug_nans"), dev)
    real, seen = train_cli.device_batch, [0]

    def poisoned(*a, **kw):
        out = real(*a, **kw)
        seen[0] += 1
        if seen[0] == bad_step:
            out["x"] = torch.full_like(out["x"], float("nan"))
        return out

    train_cli.device_batch = poisoned
    try:
        exp.train_one_epoch(0)
        msg = None
    except FloatingPointError as e:
        msg = str(e)
    finally:
        train_cli.device_batch = real
        exp.log.close()
    check(msg is not None and f"step {bad_step} " in msg,
          f"--debug_nans at --steps_per_call {k}, NaN step {bad_step}: "
          f"{msg!r}")
    return msg


def dropout_replays(tmp, dev):
    """--network resnet18 (the linear head, dropout 0.05) at GRAPH_CLIPS
    float32 clips and lr 0, one batch in every slot: the losses of two
    replays differ step by step (new masks each replay), and after the
    generator is reseeded a replay repeats the eager first group's masks.
    -> record."""
    from zeroshotvideoclassification_tpu_torch.train import set_lr

    exp, host, ce = experiment(cli_argv(
        tmp, dev, "float32", GRAPH_CLIPS, GRAPH_CLIPS, "--steps_per_call",
        str(GRAPH_K), network="resnet18"), dev)
    check(exp.model.dropout_rate > 0, "resnet18's head has no dropout")
    set_lr(exp.optimizer, 0.0)
    scan = exp.scan_step
    b = to_card(exp, host_rows(host, slice(0, GRAPH_CLIPS)))
    for k in range(GRAPH_K):
        scan.stage(k, b["x"], b["z"], b["label"], b["weight"])
    rng = exp.rng.manual_seed(7)
    runs = [scan.run(GRAPH_K, ce, rng)["loss"].tolist() for _ in range(3)]
    rng.manual_seed(7)
    again = scan.run(GRAPH_K, ce, rng)["loss"].tolist()
    exp.log.close()

    def rel(u, v):
        return [abs(a - c) / abs(c) for a, c in zip(u, v)]

    across = rel(runs[1], runs[2])
    within = rel(runs[1][1:], runs[1][:-1])
    reseeded = rel(again, runs[0])
    say(f"[train_graphs] resnet18, dropout {exp.model.dropout_rate}, lr 0, "
        f"one batch of {GRAPH_CLIPS} float32 clips in every slot: losses of "
        f"the eager group {runs[0]}, two replays {runs[1]}, {runs[2]}: "
        f"replay against replay rel {min(across):.3g}-{max(across):.3g}, "
        f"step against step {min(within):.3g}-{max(within):.3g}; reseeded, "
        f"a replay against the eager group {max(reseeded):.3g}")
    # one mask drawn twice gives the same loss within ~1e-7 (the reseeded
    # replay against the eager group); new masks move it by ~1e-3
    check(min(across) > 1e-5 and min(within) > 1e-5,
          f"dropout masks repeated: {runs}")
    check(max(reseeded) < 1e-6, f"reseeded replay {again} vs {runs[0]}")
    return {"losses": runs, "reseeded": again}


def remat_group(tmp, dev):
    """--remat full at GRAPH_CLIPS float32 clips: two groups of GRAPH_K on
    one batch (the first eager, the second a replay) against 2 GRAPH_K
    single steps from the same state: losses rtol 1e-4, BN running
    statistics as far apart as float32 allows and every num_batches_tracked
    2 GRAPH_K (moved once a step); the recomputed blocks' epilogues are in
    the graph (72 K forward kernels). -> record."""
    from torch_helpers import seed_adam

    runs = {}
    for k in (GRAPH_K, 1):
        exp, host, ce = experiment(cli_argv(
            tmp, dev, "float32", GRAPH_CLIPS, GRAPH_CLIPS,
            "--steps_per_call", str(k), "--remat", "full"), dev)
        seed_adam(exp.optimizer, exp.model, seed=3, count=1000)
        b = to_card(exp, host_rows(host, slice(0, GRAPH_CLIPS)))
        batch = (b["x"], b["z"], b["label"], b["weight"])
        stats0 = bn_running(exp.model).clone()
        if k > 1:
            for j in range(k):
                exp.scan_step.stage(j, *batch)
            losses = [v for _ in range(2) for v in
                      exp.scan_step.run(k, ce)["loss"].tolist()]
            nodes = graph_kernels(exp.scan_step.graphs[k][0],
                                  os.path.join(tmp, "remat.dot"))
        else:
            losses = [float(exp.train_step(*batch, ce)["loss"])
                      for _ in range(2 * GRAPH_K)]
        tracked = {int(v) for n, v in exp.model.state_dict().items()
                   if n.endswith("num_batches_tracked")}
        runs[k] = (losses, bn_running(exp.model) - stats0, tracked)
        exp.log.close()
        del exp
        release()
    (lg, mg, tg), (le, me, te) = runs[GRAPH_K], runs[1]
    rel = max(abs(a - c) / abs(c) for a, c in zip(lg, le))
    off = float((mg - me).abs().max())
    say(f"[train_graphs] --remat full, {GRAPH_CLIPS} float32 clips: two "
        f"groups of {GRAPH_K} (eager, replay) against {2 * GRAPH_K} single "
        f"steps: losses rel {rel:.2g}, running statistics {off:.3g} apart "
        f"(moved up to {float(me.abs().max()):.3g}), num_batches_tracked "
        f"{sorted(tg)} / {sorted(te)}; kernel nodes of the replay {nodes}")
    check(rel <= 1e-4 and tg == te == {2 * GRAPH_K}
          and off <= 1e-3 * float(me.abs().max()),
          f"remat under graphs: {rel}, {off}, {tg}, {te}")
    check(nodes["bn_apply_relu"] == 72 * GRAPH_K
          and nodes["bn_apply_relu_bwd"] == 74 * GRAPH_K
          and nodes["bn_sums"] == 144 * GRAPH_K
          and nodes["bn_moments"] == 72 * GRAPH_K
          and nodes["bn_sums_grad"] == nodes["bn_moments_grad"]
          == 37 * GRAPH_K,
          f"remat graph's K2 and BN statistics kernels {nodes}")
    return {"loss_rel": rel, "running_stats_max_abs": off, "nodes": nodes}


# F4's hold: GiB the ballast leaves free before the first group of the
# float32 step of TRAIN_BS clips (its eager peak: 11.7 GiB allocated,
# 13.7 reserved on the H100, tools/f4_probe.py): too little for the
# steps, twice; enough for the steps, but not also for a capture beside
# the eager group's cached blocks (where a capture used to fail); plenty
F4_LEVELS = (0.5, 13.5, 15.0, 40.0)


def capture_under_ballast(tmp, dev, smi):
    """F4's hold: at each of F4_LEVELS, a fresh Experiment (float32,
    TRAIN_BS clips, --steps_per_call GRAPH_K, the seeded Adam state) gets a
    ballast tensor that leaves that many GiB of the card free, then runs
    two groups on one batch (the first eager, then captured; the second a
    replay). Each level ends in a completed run within phase 19's f32 bars
    of 2 GRAPH_K single steps from the same state (losses rtol 1e-4,
    parameters atol 2e-5) or in torch.OutOfMemoryError; any other error
    fails the phase. -> record."""
    import torch

    from torch_helpers import seed_adam

    def run(k, level=None):
        exp, host, ce = experiment(cli_argv(
            tmp, dev, "float32", TRAIN_BS, TRAIN_BS, "--steps_per_call",
            str(k)), dev)
        seed_adam(exp.optimizer, exp.model, seed=3, count=1000)
        b = to_card(exp, host)
        batch = (b["x"], b["z"], b["label"], b["weight"])
        out = {}
        ballast = None
        if level is not None:
            torch.cuda.synchronize()
            free = torch.cuda.mem_get_info()[0]
            # whole 2 MiB pages: a block that fills its segment leaves no
            # free tail in it for a later tensor to pin (the segment then
            # is released with the ballast)
            take = max(free - int(level * 2 ** 30), 0) // 2 ** 21 * 2 ** 21
            ballast = torch.empty(take, dtype=torch.uint8, device=dev)
            out["free_GiB"] = torch.cuda.mem_get_info()[0] / 2 ** 30
        try:
            if k > 1:
                for j in range(k):
                    exp.scan_step.stage(j, *batch)
                out["losses"] = [v for _ in range(2) for v in
                                 exp.scan_step.run(k, ce)["loss"].tolist()]
                out["capture_s"] = exp.scan_step.captured["seconds"]
            else:
                out["losses"] = [float(exp.train_step(*batch, ce)["loss"])
                                 for _ in range(2 * GRAPH_K)]
            torch.cuda.synchronize()
            out["outcome"] = "completed"
            out["params"] = {n: v.detach().cpu()
                             for n, v in exp.model.named_parameters()}
        except torch.OutOfMemoryError as e:
            out["outcome"] = "OutOfMemoryError"
            out["message"] = str(e).splitlines()[0][:200]
        exp.log.close()
        del exp, ballast, b, batch
        release()
        return out

    ref = run(1)
    levels = []
    for level in F4_LEVELS:
        r = run(GRAPH_K, level)
        rec = {k: v for k, v in r.items() if k != "params"}
        rec["level_GiB"] = level
        if r["outcome"] == "completed":
            rec["loss_rel"] = max(abs(a - c) / abs(c) for a, c in
                                  zip(r["losses"], ref["losses"]))
            rec["param_max_abs"] = max(
                float((r["params"][n] - ref["params"][n]).abs().max())
                for n in ref["params"])
            check(rec["loss_rel"] <= 1e-4 and rec["param_max_abs"] <= 2e-5,
                  f"F4 hold at {level} GiB: {rec}")
        levels.append(rec)
        say(f"[train_graphs] F4 hold: {level} GiB left free ({rec['free_GiB']:.2f}"
            f" measured) before a group of {GRAPH_K} float32 steps of "
            f"{TRAIN_BS} clips: {rec['outcome']}"
            + (f" (capture {rec['capture_s']:.2f} s; losses rel "
               f"{rec['loss_rel']:.2g}, parameters "
               f"{rec['param_max_abs']:.3g} from single steps)"
               if rec["outcome"] == "completed" else
               f": {rec['message']}") + f"  ({smi})")
    return levels


GRAPH_OPTIONS = (("--remat", "convs"), ("--fixconvs",),
                 ("--network", "c3d"), ("--clip_pool", "embedding"),
                 ("--head", "linear"))


def graph_options(tmp, dev):
    """The trainer's other options under CUDA graphs (tools/graph_phase.py
    runs this after phase 19; chip_smoke.py does not): for each of
    GRAPH_OPTIONS, two groups of 2 float32 steps of GRAPH_CLIPS clips (the
    first eager, then a replay) against 4 single steps from the same state
    and generator: losses rtol 1e-4. -> {option: loss rel}."""
    from torch_helpers import seed_adam

    out = {}
    for flags in GRAPH_OPTIONS:
        losses = {}
        for k in (2, 1):
            exp, host, ce = experiment(cli_argv(
                tmp, dev, "float32", GRAPH_CLIPS, GRAPH_CLIPS,
                "--steps_per_call", str(k), *flags), dev)
            seed_adam(exp.optimizer, exp.model, seed=3, count=1000)
            b = to_card(exp, host_rows(host, slice(0, GRAPH_CLIPS)))
            batch = (b["x"], b["z"], b["label"], b["weight"])
            rng = exp.rng.manual_seed(11)
            if k > 1:
                for j in range(k):
                    exp.scan_step.stage(j, *batch)
                losses[k] = [v for _ in range(2) for v in
                             exp.scan_step.run(k, ce, rng)["loss"].tolist()]
            else:
                losses[k] = [float(exp.train_step(*batch, ce, rng)["loss"])
                             for _ in range(4)]
            exp.log.close()
            del exp
            release()
        rel = max(abs(a - c) / abs(c) for a, c in zip(losses[2], losses[1]))
        say(f"[train_graphs] {' '.join(flags)}: two groups of 2 float32 "
            f"steps of {GRAPH_CLIPS} clips (eager, replay) against 4 single "
            f"steps: losses rel {rel:.2g}; {losses[2]}")
        check(rel <= 1e-4, f"{flags} under graphs: {rel}")
        out[" ".join(flags)] = rel
    RECORD["graph_options"] = out
    return out


def graphs_nccl_job(rank, world, dev, out_dir, join, tp=1):
    """Phase 19 in an NCCL group (one process a GPU): two groups of
    GRAPH_K float32 steps of GRAPH_CLIPS clips a data shard (eager, then a
    replay whose all-reduces are captured) against 2 GRAPH_K single steps
    in the same group from the same state; at --tp `tp` the processes of a
    model group share a shard. -> the losses of both and the largest
    parameter difference."""
    import torch

    from torch_helpers import seed_adam

    join()
    d = rank // tp
    rows = slice(d * GRAPH_CLIPS, (d + 1) * GRAPH_CLIPS)
    out = {"backend": torch.distributed.get_backend()}
    params = {}
    for k in (GRAPH_K, 1):
        exp, host, ce = experiment(cli_argv(
            out_dir, dev, "float32", GRAPH_CLIPS, world // tp * GRAPH_CLIPS,
            "--steps_per_call", str(k), "--tp", str(tp)), dev)
        seed_adam(exp.optimizer, exp.model, seed=3, count=1000)
        b = to_card(exp, host_rows(host, rows))
        batch = (b["x"], b["z"], b["label"], b["weight"])
        if k > 1:
            for j in range(k):
                exp.scan_step.stage(j, *batch)
            out[k] = [v for _ in range(2) for v in
                      exp.scan_step.run(k, ce)["loss"].tolist()]
        else:
            out[k] = [float(exp.train_step(*batch, ce)["loss"])
                      for _ in range(2 * GRAPH_K)]
        params[k] = {n: v.detach().clone()
                     for n, v in exp.model.named_parameters()}
        exp.log.close()
        del exp
        release()
    out["param_max_abs"] = max(float((params[GRAPH_K][n] - params[1][n])
                                     .abs().max()) for n in params[1])
    return out


def graphs_timed_job(rank, world, dev, out_dir, join):
    """graphs_nccl_job, then the bf16 step of GRAPH_CLIPS clips a process
    timed eagerly and as a replay of GRAPH_K steps / GRAPH_K (tools/
    graph_phase.py --nccl_only; chip_smoke.py does not run it)."""
    out = graphs_nccl_job(rank, world, dev, out_dir, join)
    exp, host, ce = experiment(cli_argv(
        out_dir, dev, "bfloat16", GRAPH_CLIPS, world * GRAPH_CLIPS,
        "--steps_per_call", str(GRAPH_K)), dev)
    b = to_card(exp, host_rows(host, slice(rank * GRAPH_CLIPS,
                                           (rank + 1) * GRAPH_CLIPS)))
    batch = (b["x"], b["z"], b["label"], b["weight"])
    for _ in range(TRAIN_WARMUP):
        exp.train_step(*batch, ce)
    eager = timed_calls(lambda: exp.train_step(*batch, ce), GRAPH_TIMED, 1)
    for k in range(GRAPH_K):
        exp.scan_step.stage(k, *batch)
    exp.scan_step.run(GRAPH_K, ce)  # the first group, then the capture
    graph = timed_calls(lambda: exp.scan_step.run(GRAPH_K, ce), GRAPH_TIMED,
                        GRAPH_K)
    exp.log.close()
    out["timed"] = {"eager": eager, "graph": graph}
    return out


def graph_nccl(tmp, timed=False):
    """graphs_nccl_job (graphs_timed_job where `timed`) in an NCCL group
    of one process, and of two where the host shows two GPUs: the grouped
    steps within loss rtol 1e-4 and parameters atol 2e-5 of single steps
    in the group, the ranks' losses equal. -> {world: record}."""
    import torch

    nccl = {}
    for world in (1, 2) if torch.cuda.device_count() >= 2 else (1,):
        rs = spawn_ranks("graphs_timed" if timed else "graphs", "nccl",
                         os.path.join(tmp, f"w{world}"), world=world)
        rel = max(abs(a - c) / abs(c) for r in rs
                  for a, c in zip(r[GRAPH_K], r[1]))
        dmax = max(r["param_max_abs"] for r in rs)
        say(f"[train_graphs] NCCL group of {world}: two groups of "
            f"{GRAPH_K} float32 steps of {GRAPH_CLIPS} clips a process with "
            f"the all-reduces captured, against single steps in the group: "
            f"losses rel {rel:.2g}, parameters {dmax:.3g} apart; ranks' "
            f"losses equal: {all(r[GRAPH_K] == rs[0][GRAPH_K] for r in rs)}")
        check(all(r["backend"] == "nccl" for r in rs) and rel <= 1e-4
              and dmax <= 2e-5, f"NCCL group of {world} under graphs: "
                                f"{rel}, {dmax}")
        check(all(r[GRAPH_K] == rs[0][GRAPH_K] for r in rs),
              "ranks' losses differ")
        nccl[world] = {"loss_rel": rel, "param_max_abs": dmax}
        if timed:
            t = [r["timed"] for r in rs]
            say(f"[train_graphs] NCCL group of {world}, bf16 step of "
                f"{GRAPH_CLIPS} clips a process: eager "
                f"{[round(x['eager']['event_ms'], 2) for x in t]} ms by CUDA "
                f"events ({[round(x['eager']['host_ms'], 2) for x in t]} by "
                f"the host's clock), a replay of {GRAPH_K} / {GRAPH_K} "
                f"{[round(x['graph']['event_ms'], 2) for x in t]} ms "
                f"({[round(x['graph']['host_ms'], 2) for x in t]}); ranks "
                f"0..{world - 1}, medians of {GRAPH_TIMED}")
            nccl[world]["timed"] = t
    return nccl


def graphs_tp_job(rank, world, dev, out_dir, join):
    """graphs_nccl_job on a grid of world / TP x TP processes (--tp TP, one
    data shard of GRAPH_CLIPS clips a model group): the model group's
    all-reduces captured beside the data group's; then the bf16 step of the
    shard timed eagerly and as a replay / GRAPH_K (tools/graph_phase.py
    --tp_grid on four GPUs; chip_smoke.py does not run it)."""
    out = graphs_nccl_job(rank, world, dev, out_dir, join, tp=TP)
    from zeroshotvideoclassification_tpu_torch.parallel import grid

    d = grid().data_index
    exp, host, ce = experiment(cli_argv(
        out_dir, dev, "bfloat16", GRAPH_CLIPS, world // TP * GRAPH_CLIPS,
        "--steps_per_call", str(GRAPH_K), "--tp", str(TP)), dev)
    b = to_card(exp, host_rows(host, slice(d * GRAPH_CLIPS,
                                           (d + 1) * GRAPH_CLIPS)))
    batch = (b["x"], b["z"], b["label"], b["weight"])
    for _ in range(TRAIN_WARMUP):
        exp.train_step(*batch, ce)
    eager = timed_calls(lambda: exp.train_step(*batch, ce), GRAPH_TIMED, 1)
    for k in range(GRAPH_K):
        exp.scan_step.stage(k, *batch)
    exp.scan_step.run(GRAPH_K, ce)  # the first group, then the capture
    graph = timed_calls(lambda: exp.scan_step.run(GRAPH_K, ce), GRAPH_TIMED,
                        GRAPH_K)
    out["calls"] = allreduce_calls(exp, batch, ce)
    exp.log.close()
    out["timed"] = {"eager": eager, "graph": graph}
    out["grid"] = [grid().n_data, grid().tp, d, grid().model_index]
    return out


def graph_tp_grid(tmp):
    """graphs_tp_job on every GPU of the host (TP_GRID of them: a 2 x TP
    grid): the grouped steps within loss rtol 1e-4 and parameters atol
    2e-5 of single steps in the grid, the losses of all processes equal,
    the bf16 step's times. -> record."""
    import torch

    world = torch.cuda.device_count()
    check(world >= TP_GRID, f"--tp_grid needs {TP_GRID} GPUs, the host "
                            f"shows {world}")
    rs = spawn_ranks("graphs_tp", "nccl", tmp, world=TP_GRID)
    rel = max(abs(a - c) / abs(c) for r in rs
              for a, c in zip(r[GRAPH_K], r[1]))
    dmax = max(r["param_max_abs"] for r in rs)
    same = all(r[GRAPH_K] == rs[0][GRAPH_K] for r in rs)
    t = [r["timed"] for r in rs]
    say(f"[train_tp_grid] NCCL, {TP_GRID} processes as "
        f"{TP_GRID // TP} x {TP} (grids {[r['grid'] for r in rs]}): two "
        f"groups of {GRAPH_K} float32 steps of {GRAPH_CLIPS} clips a data "
        f"shard with the data and model groups' all-reduces captured, "
        f"against single steps in the grid: losses rel {rel:.2g}, "
        f"parameters {dmax:.3g} apart; all processes' losses equal: {same}; "
        f"all-reduces a step by group {rs[0]['calls']}; bf16 step of "
        f"{GRAPH_CLIPS} clips a data shard: eager "
        f"{[round(x['eager']['event_ms'], 2) for x in t]} ms by CUDA events "
        f"({[round(x['eager']['host_ms'], 2) for x in t]} by the host's "
        f"clock), a replay of {GRAPH_K} / {GRAPH_K} "
        f"{[round(x['graph']['event_ms'], 2) for x in t]} ms "
        f"({[round(x['graph']['host_ms'], 2) for x in t]}); medians of "
        f"{GRAPH_TIMED}")
    check(all(r["backend"] == "nccl" for r in rs) and rel <= 1e-4
          and dmax <= 2e-5 and same, f"the 2 x {TP} grid under graphs: "
                                     f"{rel}, {dmax}, {same}")
    return {"loss_rel": rel, "param_max_abs": dmax, "timed": t,
            "calls": rs[0]["calls"], "grids": [r["grid"] for r in rs]}


def phase_graphs(tmp, dev, smi):
    """Phase 19: --steps_per_call as CUDA graphs of the train step.
    -> the entry point's launches in the two-epoch run."""
    import torch

    t0 = time.perf_counter()
    two, launches = graph_parity(tmp, dev, GRAPH_K * TRAIN_BS * 2, 2,
                                 "train_graphs")
    tail, _ = graph_parity(tmp, dev, (GRAPH_K + 2) * TRAIN_BS, 1,
                           "train_graphs tail")
    release()
    timing = graph_timing(tmp, dev, smi)
    release()
    msgs = {k: debug_nans_epoch(tmp, dev, k, bad)
            for k, bad in ((GRAPH_K, GRAPH_K + 2), (1, 2))}
    say(f"[train_graphs] --debug_nans: {msgs}")
    release()
    dropout = dropout_replays(tmp, dev)
    remat = remat_group(tmp, dev)
    release()
    ballast = capture_under_ballast(tmp, dev, smi)
    nccl = graph_nccl(tmp)
    say(f"[train_graphs] phase 19 in {time.perf_counter() - t0:.1f} s")
    RECORD["train_graphs"] = {
        "launches": launches, "two_epochs": two, "tail": tail, **timing,
        "debug_nans": msgs, "dropout": dropout, "remat": remat,
        "ballast": ballast, "nccl": nccl}
    return launches


# ------------------- the head's tensor parallelism (phase 20) ----

TP = 2        # --tp of phase 20: one model group of two processes
TP_GRID = 4   # processes of tools/graph_phase.py --tp_grid: 2 x TP


def allreduce_calls(exp, batch, ce):
    """The all-reduces one train step of `exp` makes, by group: "data"
    (BN's statistics and their gradients, the loss's weight sum, the head
    shards' gradients, the metrics), "model" (the head's two and the
    guard's flag), "world" (the replicated parameters' gradients).
    -> {group: calls}."""
    import collections

    import torch
    import torch.distributed as dist

    from zeroshotvideoclassification_tpu_torch.parallel import grid

    g = grid()
    names = {id(g.data_group): "data", id(g.model_group): "model"}
    seen = collections.Counter()
    orig = dist.all_reduce

    def counting(tensor, *a, **kw):
        group = kw.get("group")
        seen["world" if group is None else names.get(id(group),
                                                     "other")] += 1
        return orig(tensor, *a, **kw)

    dist.all_reduce = counting
    try:
        exp.train_step(*batch, ce)
        torch.cuda.synchronize()
    finally:
        dist.all_reduce = orig
    return dict(seen)


def tp_step_job(rank, world, dev, out_dir, join):
    """Phase 20 in one process of a 1 x TP grid (--tp TP): two float32 steps
    on the whole batch of TRAIN_BS clips with this process's shard of the
    head (parameters saved beside), then the timed bf16 steps with the
    launches counted, and one step's all-reduces by group."""
    import torch

    from zeroshotvideoclassification_tpu_torch.parallel import grid

    join()
    rows = slice(0, TRAIN_BS)
    losses, params = f32_steps(cli_argv(out_dir, dev, "float32", TRAIN_BS,
                                        TRAIN_BS, "--tp", str(TP)), dev, rows)
    path = os.path.join(out_dir, f"params_{rank}.pt")
    torch.save(params, path)
    g = grid()
    timed, exp, b, ce = dp_timed_steps(
        cli_argv(out_dir, dev, "bfloat16", TRAIN_BS, TRAIN_BS, "--tp",
                 str(TP)), dev, rows)
    calls = allreduce_calls(exp, (b["x"], b["z"], b["label"], b["weight"]),
                            ce)
    # BN's running statistics after the steps, then after the model group's
    # broadcast (what an evaluation or a checkpoint reads)
    torch.cuda.synchronize()
    before = bn_running(exp.model).cpu()
    exp.agree_bn_statistics()
    bn = (before, bn_running(exp.model).cpu())
    agree_ms = []  # the broadcast's host time, between two synchronises
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        exp.agree_bn_statistics()
        torch.cuda.synchronize()
        agree_ms.append((time.perf_counter() - t0) * 1e3)
    exp.log.close()
    return {"losses": losses, "params": path, "timed": timed, "calls": calls,
            "grid": [g.n_data, g.tp, g.data_index, g.model_index],
            "backend": torch.distributed.get_backend(), "bn": bn,
            "agree_ms": statistics.median(agree_ms)}


def tp_cli_job(rank, world, dev, out_dir, join):
    """Phase 20's trainer in one process: cli.main at --tp TP, one epoch of
    2 steps of TRAIN_BS clips (one data shard), the evaluation,
    --checkpoint_every 1; BN's running statistics before and after each
    of the model group's broadcasts (before the evaluation, before the
    checkpoint) recorded."""
    from zeroshotvideoclassification_tpu_torch.cli import main as train_cli

    agree = train_cli.Experiment.agree_bn_statistics
    seen = []

    def recording(exp):
        before = bn_running(exp.model).cpu()
        agree(exp)
        seen.append((before, bn_running(exp.model).cpu()))

    train_cli.Experiment.agree_bn_statistics = recording
    res = cli_job(dev, out_dir, join, cli_argv(
        out_dir, dev, "bfloat16", TRAIN_BS, 2 * TRAIN_BS,
        "--checkpoint_every", "1", "--tp", str(TP)))
    return {**res, "bn": seen}


def bn_apart(rs):
    """BN's running statistics of the processes `rs` (each (before, after)
    the model group's broadcast): -> (the largest difference between
    processes 0 and 1 before it, bit-equal after it)."""
    (b0, a0), (b1, a1) = rs
    return float((b0 - b1).abs().max()), bool(a0.equal(a1))


def phase_tp(tmp, dev, smi, f32_plain):
    """Phase 20: --tp TP on two spawned processes (NCCL on cuda:0 and
    cuda:1 where the host shows two GPUs, else gloo with both on cuda:0).
    Two float32 steps of r2plus1d_18 on TRAIN_BS clips against phase 16's
    one process (loss rtol 1e-4; parameters atol 2e-5 with the head's
    shards made whole); the backbone bit-equal across the processes; per
    process one K1 and 37 / 37 K2 a step, and 77 data-group, 3
    model-group and 1 whole-group (the replicas' gradients, averaged over
    the model group) all-reduces a step; the bf16 step's time (on one GPU a
    correctness figure, not a scaling one); BN's running statistics
    bit-equal across the model group after its broadcast (how far apart
    they were before it is printed); then cli.main at --tp TP with the
    evaluation and a checkpoint (the head whole in it; the running
    statistics bit-equal after the broadcast before each), and a
    one-process --evaluate of that checkpoint, which gives its accuracy.
    -> (backend, process 0's launches)."""
    import torch

    from zeroshotvideoclassification_tpu_torch.cli import main as train_cli
    from zeroshotvideoclassification_tpu_torch.models import bridge
    from zeroshotvideoclassification_tpu_torch.train import read_checkpoint

    backend = "nccl" if torch.cuda.device_count() >= 2 else "gloo"
    t0 = time.perf_counter()
    rs = spawn_ranks("tp_step", backend, tmp)
    wall = time.perf_counter() - t0
    l_one, p_one = f32_plain
    check(all(r["backend"] == backend for r in rs), "backend")
    check([r["grid"] for r in rs] == [[1, TP, 0, m] for m in range(TP)],
          f"grids {[r['grid'] for r in rs]}")
    check(rs[0]["losses"] == rs[1]["losses"],
          f"processes' losses {[r['losses'] for r in rs]}")
    shards = [torch.load(r["params"], weights_only=True) for r in rs]
    same = all(torch.equal(shards[0][k], shards[1][k]) for k in shards[0]
               if k not in bridge.TP_AXES)
    check(same, "train_tp_2rank: the backbone differs across the processes")
    whole = bridge.unshard_head(shards)
    rel = max(abs(a - b) / abs(b) for a, b in zip(rs[0]["losses"], l_one))
    dmax = max(float((whole[k] - p_one[k]).abs().max()) for k in p_one)
    steps = DP_WARMUP + DP_TIMED
    for r in rs:
        check(r["timed"]["launches"] == expect(1, 37 * steps, 37 * steps),
              f"train_tp_2rank launches {r['timed']['launches']}")
        check(r["calls"] == {"data": 77, "world": 1, "model": 3},
              f"train_tp_2rank all-reduces a step {r['calls']}")
    bn_steps = bn_apart([r["bn"] for r in rs])
    say(f"[train_tp_2rank] BN's running statistics ({rs[0]['bn'][0].numel()}"
        f" values) after {steps + 1} bf16 steps: {bn_steps[0]:.3g} apart "
        f"across the model group before its broadcast, bit-equal after it: "
        f"{bn_steps[1]}; the broadcast "
        f"{[round(r['agree_ms'], 3) for r in rs]} ms (processes 0, 1; host "
        f"clock between two synchronises, median of 5)")
    check(bn_steps[1], "train_tp_2rank: BN's running statistics differ "
          "across the model group after its broadcast")
    say(f"[train_tp_2rank] {backend}, --tp {TP} on 2 processes "
        f"{'on cuda:0 and cuda:1' if backend == 'nccl' else 'both on cuda:0'}"
        f" (one model group, {TRAIN_BS} clips each): 2 float32 steps, losses "
        f"{rs[0]['losses']} vs {l_one} of one process (rel {rel:.2g}, bar "
        f"1e-4), parameters with the head gathered {dmax:.3g} apart (bar "
        f"2e-5), the backbone bit-equal across the processes; launches a "
        f"process {rs[0]['timed']['launches']} over {steps} steps; "
        f"all-reduces a step {rs[0]['calls']}")
    check(rel <= 1e-4 and dmax <= 2e-5,
          f"train_tp_2rank against one process: {rel}, {dmax}")
    say(f"[train_tp_2rank] bf16 step of {TRAIN_BS} clips a process: "
        f"{[round(r['timed']['event_ms'], 2) for r in rs]} ms by CUDA events, "
        f"{[round(r['timed']['host_ms'], 2) for r in rs]} ms by the host's "
        f"clock (processes 0, 1; medians of {DP_TIMED}); "
        + ("both processes share one GPU under gloo: a correctness run, not "
           "a scaling figure" if backend == "gloo" else "one GPU each")
        + f"; the steps' run {wall:.1f} s  ({smi})")

    cli = spawn_ranks("tp_cli", backend, tmp)
    keys = ("loss", "train_accuracy", "synthetic_test_accuracy",
            "best_accuracy")
    check(all(cli[0]["summary"][k] == cli[1]["summary"][k] for k in keys),
          f"cli_tp_2rank summaries {[r['summary'] for r in cli]}")
    check(cli[1]["writes"] == [], f"process 1 wrote {cli[1]['writes']}")
    lasts = [w for w in cli[0]["writes"] if w.endswith("last.npz")]
    check(bool(lasts), f"process 0 wrote {cli[0]['writes']}")
    for r in cli:  # 2 steps and one evaluation dispatch of 16 videos
        check(r["launches"] == expect(3, 37 * 3, 37 * 2),
              f"cli_tp_2rank launches {r['launches']}")
    # one broadcast before the evaluation, one before the checkpoint
    check(len(cli[0]["bn"]) == len(cli[1]["bn"]) == 2,
          f"cli_tp_2rank: BN broadcasts {[len(r['bn']) for r in cli]}")
    bn_cli = [bn_apart(pair) for pair in zip(cli[0]["bn"], cli[1]["bn"])]
    say(f"[cli_tp_2rank] BN's running statistics across the model group "
        f"(before the evaluation, before the checkpoint): "
        f"{[round(d, 12) for d, _ in bn_cli]} apart before each broadcast, "
        f"bit-equal after it: {[same for _, same in bn_cli]}")
    check(all(same for _, same in bn_cli),
          "cli_tp_2rank: BN's running statistics differ across the model "
          "group at the evaluation or the checkpoint")
    run = os.path.dirname(os.path.join(cli[0]["root"], lasts[0]))
    fc1 = read_checkpoint(os.path.join(run, "last.npz"))[0]["head/fc1/w"]
    check(fc1.shape == (512, 512), f"the checkpoint's fc1 {fc1.shape}")
    ckpt = os.path.join(run, "checkpoint.npz")
    if not os.path.exists(ckpt):  # accuracy 0: no best checkpoint
        ckpt = os.path.join(run, "last.npz")
    acc = train_cli.main(cli_argv(os.path.join(tmp, "tp_eval"), dev,
                                  "bfloat16", TRAIN_BS, 2 * TRAIN_BS,
                                  "--evaluate", "--weights", ckpt))
    torch.cuda.synchronize()
    want = cli[0]["summary"]["synthetic_test_accuracy"]
    say(f"[cli_tp_2rank] {backend}: cli.main --tp {TP} on 2 processes in "
        f"{cli[0]['seconds']:.1f} s: loss {cli[0]['summary']['loss']:.5f}, "
        f"test accuracy {want:.1f} on both; process 0 wrote "
        f"{len(cli[0]['writes'])} files (fc1 whole: {tuple(fc1.shape)}), "
        f"process 1 none; launches a process {cli[0]['launches']}; "
        f"--evaluate of {os.path.basename(ckpt)} on one process: "
        f"{acc['synthetic_test_accuracy']:.1f}  ({smi})")
    check(acc["synthetic_test_accuracy"] == want,
          f"--evaluate of the --tp {TP} checkpoint: {acc} vs {want}")
    RECORD["train_tp_2rank"] = {
        "bn_apart_before_broadcast": {"steps": bn_steps[0],
                                      "cli": [d for d, _ in bn_cli]},
        "bn_broadcast_ms": [r["agree_ms"] for r in rs],
        "backend": backend, "loss_rel": rel, "param_max_abs": dmax,
        "timed": [r["timed"] for r in rs], "calls": rs[0]["calls"],
        "seconds": wall, "cli": [r["summary"] for r in cli],
        "cli_launches": [r["launches"] for r in cli], "evaluate": acc}
    return backend, rs[0]["timed"]["launches"]


# ------- the engine over replicas, the dry run and P11b (phases 21-23) ----

REPLICA_BUCKETS = (8, 16, 32, 64, 128)  # phase 21's forward clips/s
REPLICA_REQUEST = 10   # videos a phase-21 comparison embeds (one dispatch)
P11B_STEPS = 2         # steps of phase 23's --save_samples epoch


def free_port():
    """A TCP port of localhost that was free a moment ago."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def served_engine(proto, devices, dtype, prepare=None, weights=None):
    """The port's engine (r2plus1d_18 + mlp, phase 5's shapes and ladder)
    over `devices`, each distinct model given its weights by `prepare`."""
    from zeroshotvideoclassification_tpu_torch.serve import InferenceEngine

    engine = InferenceEngine(
        [f"video{k:02d}" for k in range(N_VIDEOS)], proto,
        network="r2plus1d_18", head="mlp", weights=weights, n_clips=N_CLIPS,
        clip_len=CLIP_LEN, size=SIZE, max_batch=MAX_BATCH,
        compute_dtype=dtype, device=devices)
    if prepare is not None:
        for m in {id(m): m for m in engine.models}.values():
            prepare(m)
    return engine


def through_serve_forever(engine, paths):
    """One POST /classify of `paths` and a GET /stats through
    serve.serve_forever (the cli.serve loop) on a thread of its own, the
    server stopped after. -> (results, stats)."""
    from zeroshotvideoclassification_tpu_torch.serve import server as srv

    made = []

    class Recorded(srv.ThreadingHTTPServer):  # the loop's server, to stop it
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made.append(self)

    port, ready = free_port(), threading.Event()
    srv.ThreadingHTTPServer = Recorded
    try:
        th = threading.Thread(target=srv.serve_forever, args=(
            engine, "127.0.0.1", port), kwargs={"ready_event": ready},
            daemon=True)
        th.start()
        check(ready.wait(60), "serve_forever did not start")
        url = f"http://127.0.0.1:{port}"
        body, _ = post(url + "/classify", {"videos": list(paths)})
        stats = get(url + "/stats")
    finally:
        if made:
            made[0].shutdown()
        srv.ThreadingHTTPServer = Recorded.__mro__[1]
    th.join(timeout=120)
    check(not th.is_alive(), "serve_forever did not stop")
    return body["results"], stats


def replica_forward_rates(models, devices, buckets=REPLICA_BUCKETS):
    """Forward clips/s at each bucket, the bucket's rows split over the
    replicas as a dispatch splits them, each replica's forward on a thread
    bound to its device, all at once; the host's clock around them (after
    one warm-up call, which times cuDNN's algorithms), median of 3."""
    import concurrent.futures as cf

    import torch

    from zeroshotvideoclassification_tpu_torch.train import eval_step

    n = len(devices)
    pools = [cf.ThreadPoolExecutor(1, initializer=torch.cuda.set_device,
                                   initargs=(d,)) for d in devices]

    def one(m, x):
        eval_step(m, x)
        torch.cuda.synchronize(x.device)

    out = {}
    try:
        for b in buckets:
            b = -(-b // n) * n
            xs = [torch.rand((b // n, N_CLIPS, CLIP_LEN, SIZE, SIZE, 3),
                             device=d).sub_(0.5).to(torch.bfloat16)
                  for d in devices]
            times = []
            for rep in range(4):
                t0 = time.perf_counter()
                for f in [p.submit(one, m, x)
                          for p, m, x in zip(pools, models, xs)]:
                    f.result()
                times.append(time.perf_counter() - t0)
            s = statistics.median(times[1:])
            out[b] = {"ms": s * 1e3, "clips_per_s": b * N_CLIPS / s}
            del xs
    finally:
        for p in pools:
            p.shutdown()
    return out


def phase_serve_replicas(tmp, paths, prepare, proto, expected, dev, smi,
                         copy_gbs, sets=None):
    """The engine over replicas: over [dev, dev], and over every visible GPU
    where the host shows two or more (or over each device list of `sets`),
    against phase 5's one-replica engine on the same weights. -> (the HTTP
    request's launches on the first replica set, K1's and K2 forward's
    records at a replica's shapes)."""
    import numpy as np
    import torch

    from zeroshotvideoclassification_tpu_torch.tools.port_checkpoint import (
        port_checkpoint,
    )

    reqs = paths[:REPLICA_REQUEST]
    one32 = served_engine(proto, dev, "float32", prepare)
    one16 = served_engine(proto, dev, "bfloat16", prepare)
    try:
        want32, _ = one32.embed_paths(reqs)
        want16, _ = one16.embed_paths(reqs)
        want_cls = one16.classify(reqs)
        # the served weights as a checkpoint for reload: the port model's
        # state dict as a .pth, through tools/port_checkpoint
        pth, npz = os.path.join(tmp, "served.pth"), os.path.join(tmp,
                                                                 "served.npz")
        torch.save({k: v.detach().cpu()
                    for k, v in one32.model.state_dict().items()}, pth)
        port_checkpoint(pth, "r2plus1d_18", "mlp", npz)
        one_rates = replica_forward_rates([one16.model], [dev])
    finally:
        one32.close()
    if sets is None:
        sets = [[dev, dev]]
        if torch.cuda.device_count() >= 2:
            sets.append("cuda")
    record, main_launches, kernels = {"sets": []}, None, None
    for devices in sets:
        rep32 = served_engine(proto, devices, "float32", prepare)
        n, devs = rep32.n_shards, rep32.devices
        tag = f"[serve_replicas {n} x {','.join(map(str, devs))}]"
        try:
            got32, ok = rep32.embed_paths(reqs)
        finally:
            rep32.close()
        err32 = float(np.abs(got32 - want32).max())
        check(ok.all() and err32 <= 1e-4, f"{tag} f32 rows: {err32}")
        rep16 = served_engine(proto, devices, "bfloat16", prepare)
        try:
            fit = [-(-b // n) * n for b in (8, 16, 32, 64) if b < MAX_BATCH]
            ladder = sorted(set(fit) | {-(-MAX_BATCH // n) * n})
            check(rep16.batch_buckets == ladder
                  and rep16.stats()["data_shards"] == n,
                  f"{tag} ladder {rep16.batch_buckets}, want {ladder}")
            t0 = time.perf_counter()
            rep16.warmup()
            warm_s = time.perf_counter() - t0
            zero_counts()
            got16, _ = rep16.embed_paths(reqs)
            launches = read_counts()
            check(launches == expect(n, 37 * n, 0),
                  f"{tag} launches of one dispatch {launches}")
            cos = [float(a @ b / np.linalg.norm(a) / np.linalg.norm(b))
                   for a, b in zip(got16, want16)]
            check(min(cos) >= BF16_COSINE_BAR, f"{tag} bf16 cosine {cos}")
            cls = [r["top_class"] for r in rep16.classify(reqs)]
            check(cls == [r["top_class"] for r in want_cls],
                  f"{tag} top classes {cls}")
            # the main path: a request through the serve CLI's loop
            d0 = rep16.stats()["dispatches"]
            zero_counts()
            results, stats = through_serve_forever(rep16, paths[:5])
            http_launches = read_counts()
            d = stats["engine"]["dispatches"] - d0
            check(stats["engine"]["data_shards"] == n and d >= 1
                  and stats["engine"]["device"] == ",".join(map(str, devs))
                  and http_launches == expect(n * d, 37 * n * d, 0),
                  f"{tag} /stats {stats}, launches {http_launches}")
            for r, path in zip(results, paths[:5]):
                want = f"video{int(expected[paths.index(path)]):02d}"
                check(r["top_class"] == want,
                      f"{tag} served {r['top_class']} for {path}, f32 says "
                      f"{want}")
            old = rep16.models
            res = rep16.reload(npz)
            check(all(all(m is not o for o in old) for m in rep16.models),
                  f"{tag} a replica kept its model across reload")
            again, _ = rep16.embed_paths(reqs)
            rcos = min(float(a @ b / np.linalg.norm(a) / np.linalg.norm(b))
                       for a, b in zip(again, got16))
            check(rcos >= 0.99999, f"{tag} after reload: cosine {rcos}")
            rates = replica_forward_rates(rep16.models, devs)
            if main_launches is None:
                main_launches = http_launches
                last = devs[-1]
                rows = -(-8 // n) * n // n  # a replica's rows at bucket 8
                k1 = phase_k1(paths, last, copy_gbs, buckets=(rows,),
                              key="k1_serve_replicas",
                              what=f"serve_replicas on {last}, a replica's "
                                   f"videos:")
                calls = epilogue_calls(rep16.models[-1], torch.zeros(
                    (rows, N_CLIPS, CLIP_LEN, SIZE, SIZE, 3), device=last,
                    dtype=torch.bfloat16))
                k2 = phase_k2(calls, last, copy_gbs, key="k2_serve_replicas",
                              what=f"at a replica's {rows} videos on {last}")
                kernels = (k1, k2)
        finally:
            rep16.close()
        say(f"{tag} f32 rows {err32:.3g} from one replica (bar 1e-4), bf16 "
            f"cosine >= {min(cos):.6f}, top classes equal; ladder "
            f"{ladder}, data_shards {n}; warmup {warm_s:.2f} s; one "
            f"dispatch {launches['video_transform']} K1 / "
            f"{launches['bn_apply_relu']} K2; POST /classify through "
            f"serve_forever: {d} dispatch(es), launches {http_launches}; "
            f"reload {res['reloaded']} swapped every replica (cosine "
            f"{rcos:.7f})")
        for b, r in rates.items():
            base = one_rates.get(b) or one_rates[min(
                one_rates, key=lambda k: abs(k - b))]
            p5 = RECORD.get("serve", {}).get("forward", {}).get(b)
            say(f"{tag} forward bucket {b} ({b * N_CLIPS} clips) bf16: "
                f"{r['ms']:.2f} ms = {r['clips_per_s']:.1f} clips/s; one "
                f"replica {base['clips_per_s']:.1f} clips/s (the same "
                f"method)" + (f", phase 5 {p5['clips_per_s']:.1f}"
                              if p5 else "") + f"  ({smi})")
        record["sets"].append({
            "devices": [str(x) for x in devs], "f32_max_abs": err32,
            "bf16_cosine": cos, "ladder": ladder, "warmup_s": warm_s,
            "dispatch_launches": launches, "http_launches": http_launches,
            "stats": stats, "reload_cosine": rcos, "forward": rates})
    record["one_replica_forward"] = one_rates
    one16.close()
    RECORD["serve_replicas"] = record
    return main_launches, kernels[0], kernels[1]


def phase_dryrun(dev, smi, copy_gbs):
    """dryrun_multichip on every visible GPU under NCCL where there are two
    or more, else on 2 processes under gloo on cuda:0; its loss against one
    process's on the same global batch; K2 forward and backward against
    their plain versions at a process's float32 shapes first. -> (process
    0's launches, K2 forward's record, K2 backward's)."""
    import torch

    from zeroshotvideoclassification_tpu_torch import dryrun
    from zeroshotvideoclassification_tpu_torch.config import Config
    from zeroshotvideoclassification_tpu_torch.models import get_network
    from zeroshotvideoclassification_tpu_torch.models.layers import (
        init_weights,
    )

    gpus = torch.cuda.device_count()
    n, backend = (gpus, None) if gpus >= 2 else (2, "gloo")
    tp = dryrun.grid_tp(n)
    rows = max(n, 2) // (n // tp)
    model = get_network(Config(network="r2plus1d_18", head="mlp"))
    init_weights(model, torch.Generator().manual_seed(0))
    model = model.to(device=dev, memory_format=torch.channels_last_3d).eval()
    calls = epilogue_calls(model, torch.zeros((rows, 1, 4, 32, 32, 3),
                                              device=dev))
    del model
    k2b, k2f = phase_k2_bwd(calls, dev, copy_gbs, key="_dryrun", clips=rows,
                            dtype=torch.float32)
    t0 = time.perf_counter()
    res = dryrun.dryrun_multichip(n, "cuda", backend=backend)
    wall = time.perf_counter() - t0
    one = dryrun.dryrun_step(n, dev)
    tag = f"[dryrun {n} x {backend or 'nccl'}]"
    say(f"{tag} mesh {res['mesh']} loss {res['loss']!r} (one process on the "
        f"same global batch: {one['loss']!r}); process 0's step "
        f"{res['step_seconds'] * 1e3:.1f} ms, one process's "
        f"{one['step_seconds'] * 1e3:.1f} ms (host clock, the first step: "
        f"cuDNN's algorithm search included); launches in process 0 "
        f"{res['launches']}; the run {wall:.1f} s  ({smi})")
    check(res["mesh"] == {"data": n // tp, "model": tp},
          f"{tag} mesh {res['mesh']}")
    check(math.isfinite(res["loss"])
          and abs(res["loss"] - one["loss"]) <= 1e-4 * abs(one["loss"]),
          f"{tag} loss {res['loss']} against {one['loss']}")
    check(res["launches"] == {"bn_apply_relu": 74, "bn_apply_relu_bwd": 37},
          f"{tag} launches {res['launches']}")
    RECORD["dryrun"] = {"n": n, "backend": backend or "nccl", **res,
                        "one_process_loss": one["loss"],
                        "one_process_step_seconds": one["step_seconds"],
                        "seconds": wall}
    return res["launches"], k2f, k2b


def phase_p11b(tmp, dev, smi, paths, prepare, proto):
    """--save_samples through one epoch of cli.main (the GIF written, or
    the warning printed where imageio is missing: either passes, and the
    line says which); then tools/port_checkpoint of a .pth of a seeded
    port model (its state dict in the reference's torchvision key names),
    loaded by the engine as --weights and by reload, its float32
    embeddings against the seeded model's. -> the epoch's launches."""
    import contextlib
    import glob
    import io

    import numpy as np
    import torch

    from zeroshotvideoclassification_tpu_torch.tools.port_checkpoint import (
        main as port_main,
    )

    root = os.path.join(tmp, "p11b")
    args = cli_argv(root, dev, "bfloat16", TRAIN_BS, TRAIN_BS * P11B_STEPS,
                    "--save_samples")
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        _, launches, _ = cli_epoch(args, "cli_save_samples", expect(
            P11B_STEPS + 2, 37 * (P11B_STEPS + 1), 37 * P11B_STEPS))
    sys.stderr.write(err.getvalue())
    gifs = glob.glob(os.path.join(root, "runs", "**", "samples", "*.gif"),
                     recursive=True)
    warned = [ln for ln in err.getvalue().splitlines()
              if ln.startswith("WARNING: --save_samples skipped (")]
    check(len(gifs) + len(warned) == 1,
          f"--save_samples: GIFs {gifs}, warnings {warned}")
    say(f"[cli_save_samples] {'the GIF ' + gifs[0] if gifs else warned[0]} "
        f"(K1 {launches['video_transform']} = {P11B_STEPS} steps, one "
        f"evaluation dispatch and the dump)")

    seeded = served_engine(proto, dev, "float32", prepare)
    pth, npz = os.path.join(root, "seeded.pth"), os.path.join(root,
                                                              "seeded.npz")
    try:
        torch.save({k: v.detach().cpu()
                    for k, v in seeded.model.state_dict().items()}, pth)
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            port_main(["--src", pth, "--network", "r2plus1d_18", "--out",
                       npz])
        want, _ = seeded.embed_paths(paths[:8])
    finally:
        seeded.close()
    loaded = served_engine(proto, dev, "float32", weights=npz)
    fresh = served_engine(proto, dev, "float32")
    try:
        by_weights, _ = loaded.embed_paths(paths[:8])
        fresh.reload(npz)
        by_reload, _ = fresh.embed_paths(paths[:8])
    finally:
        loaded.close()
        fresh.close()
    e1 = float(np.abs(by_weights - want).max())
    e2 = float(np.abs(by_reload - want).max())
    say(f"[port_checkpoint] {out.getvalue().strip()}; --weights "
        f"embeddings {e1:.3g}, reload {e2:.3g} from the seeded model's "
        f"(bar 1e-4)  ({smi})")
    check(e1 <= 1e-4 and e2 <= 1e-4, f"ported weights: {e1}, {e2}")
    RECORD["p11b"] = {"gif": gifs, "warning": warned, "launches": launches,
                      "port_checkpoint_max_abs": [e1, e2]}
    return launches


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--json", default=None,
                   help="also write every measurement to this file")
    args = p.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this needs "
              "an NVIDIA GPU", file=sys.stderr)
        return 2
    import zeroshotvideoclassification_tpu_torch  # noqa: F401  (the port)

    # the helpers shared with the port's tests (numpy and torch only)
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(
        __file__)), "tests"))
    from torch_helpers import copy_bn

    dev = torch.device(DEVICE)
    # the serving settings (cli/infer.build_scoring_state)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.benchmark = True

    lap("start")
    smi = phase_env()
    phase_build()
    lap('build')
    copy_gbs = measure_copy_bandwidth(dev)
    lap('copy')
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        t0 = time.perf_counter()
        paths = make_videos(tmp)
        say(f"[data] {N_VIDEOS} seeded clips {FRAMES}x{HEIGHT}x{WIDTH}x3 "
            f"uint8 written in {time.perf_counter() - t0:.1f} s")
        k1 = phase_k1(paths, dev, copy_gbs)
        lap('1 k1')
        m32, m16, proto, expected = phase_model(paths, dev)
        lap('2 model')
        calls = epilogue_calls(m16, torch.zeros(
            (8, N_CLIPS, CLIP_LEN, SIZE, SIZE, 3), device=dev,
            dtype=torch.bfloat16))
        del m16
        k2 = phase_k2(calls, dev, copy_gbs)
        lap('3 k2')
        # phase 4's weights: the same seeded init, and its BN statistics
        serve_launches = phase_serve(paths, lambda m: copy_bn(m32, m), proto,
                                     expected, dev, smi)
        lap('5 serve')
        train_calls = epilogue_calls(m32, torch.zeros(
            (TRAIN_BS, 1, CLIP_LEN, SIZE, SIZE, 3), device=dev))
        # phase 4's BN statistics for the served models of phases 21, 23
        serve_bn = copy.deepcopy(m32).cpu()
        del m32
        torch.cuda.empty_cache()
        k2b, k2_train = phase_k2_bwd(train_calls, dev, copy_gbs)
        lap('6 k2_bwd')
        torch.cuda.empty_cache()
        bn_stats = phase_bn_stats(train_calls, dev, copy_gbs)
        lap('6b bn_stats')
        torch.cuda.empty_cache()
        train_launches, k1_train, train_summary = phase_train(
            tmp, dev, smi, copy_gbs)
        lap('7 train')
        torch.cuda.empty_cache()
        phase_checkpoint(tmp, dev, smi, train_summary)
        lap('7b checkpoint')
        torch.cuda.empty_cache()
        k4 = phase_k4(dev, copy_gbs, smi)
        lap('8 k4')
        sun_launches, _ = phase_sun(tmp, dev, smi)
        lap('9 sun')
        torch.cuda.empty_cache()
        k3_launches, k3 = phase_k3(dev, copy_gbs, smi)
        lap('10 k3')
        torch.cuda.empty_cache()
        c3d_launches = phase_train_c3d(tmp, dev, smi)
        lap('11 train_c3d')
        torch.cuda.empty_cache()
        serve_c3d_launches = phase_serve_c3d(paths, dev, smi)
        lap('12 serve_c3d')
        torch.cuda.empty_cache()
        r3d_launches, k2_r3d, k2b_r3d = phase_train_resnet18(tmp, dev, smi,
                                                             copy_gbs)
        lap('13 resnet18')
        torch.cuda.empty_cache()
        remat_launches = phase_remat(tmp, dev, smi)
        lap('14 remat')
        torch.cuda.empty_cache()
        fix_launches = phase_fixconvs(tmp, dev)
        lap('15 fixconvs')
        torch.cuda.empty_cache()
        (x3d_launches, k1_x3d, k2_x3d, k2b_x3d, bn_x3d,
         dwconv_x3d) = phase_train_x3d(tmp, dev, smi, copy_gbs)
        lap('15b train_x3d')
        release()
        k1_dp, k2b_dp, k2_dp = phase_dp_kernels(tmp, dev, copy_gbs)
        lap('16 dp kernels')
        torch.cuda.empty_cache()
        dp1_launches, f32_plain = phase_dp_world1(tmp, smi)
        lap('16 dp_world1')
        torch.cuda.empty_cache()
        _, dp2_launches = phase_dp_2rank(tmp, dev, smi, f32_plain)
        lap('17 dp_2rank')
        cli_dp_launches = phase_dp_cli(tmp, dev, smi)
        lap('18 dp_cli')
        torch.cuda.empty_cache()
        graph_launches = phase_graphs(tmp, dev, smi)
        lap('19 graphs')
        release()
        _, tp_launches = phase_tp(tmp, dev, smi, f32_plain)
        lap('20 tp')
        del f32_plain
        release()
        replica_launches, k1_rep, k2_rep = phase_serve_replicas(
            tmp, paths, lambda m: copy_bn(serve_bn, m), proto, expected,
            dev, smi, copy_gbs)
        lap('21 serve_replicas')
        release()
        dry_launches, k2_dry, k2b_dry = phase_dryrun(dev, smi, copy_gbs)
        lap('22 dryrun')
        release()
        p11b_launches = phase_p11b(tmp, dev, smi, paths,
                                   lambda m: copy_bn(serve_bn, m), proto)
        lap('23 p11b')
        release()
        k4_trace(dev, k4, smi)
        lap('8 k4 trace')

    outside = [m for m in sys.modules if m.split(".")[0] in (
        "jax", "jaxlib", "zeroshotvideoclassification_tpu")]
    check(not outside, f"JAX or the JAX package was imported: {outside[:5]}")
    src = "zeroshotvideoclassification_tpu_torch/csrc/"
    ops = "zeroshotvideoclassification_tpu/ops/"

    def row(name, source, replaces, path, launches, rec, **extra):
        """One kernel on one main path: its launches in that path's run
        and its measurements at that path's shapes."""
        return {"name": name, "path": path, "route": "cuda", **extra,
                "source": src + source, "replaces": ops + replaces,
                "launches": launches[name],
                "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
                "launch_ms": rec.get("launch_ms", rec.get("launches_ms")),
                "trace_ms": rec.get("trace_ms"),
                "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
                "bound_by": rec["bound_by"],
                "copy_bound_ms": rec["copy_bound_ms"],
                "library_ms": rec.get("library_ms"),
                **({"library_shapes_ms": rec["library_shapes_ms"]}
                   if "library_shapes_ms" in rec else {})}

    k1_at, k2_at = "resample_pallas.py:74", "bn_pallas.py:131"
    kernels = {"kernels": [
        row("video_transform", "video_transform.cu", k1_at, "serve",
            serve_launches, k1),
        row("video_transform", "video_transform.cu", k1_at, "train",
            train_launches, k1_train),
        row("bn_apply_relu", "bn_apply_relu.cu", k2_at, "serve",
            serve_launches, k2),
        row("bn_apply_relu", "bn_apply_relu.cu", k2_at, "train",
            train_launches, k2_train),
        row("bn_apply_relu_bwd", "bn_apply_relu.cu", "bn_pallas.py:173",
            "train", train_launches, k2b),
        # the BN statistics' ops and their gradients (no TPU kernel: XLA
        # computed these statistics in the JAX package): launches in the
        # train path's run (37 of each a step), measured at the train
        # cell's 64 clips (phase 6b)
        {**row("bn_sums", "bn_stats.cu", "", "train", train_launches,
               bn_stats, clips=bn_stats["clips"],
               grad_launches=train_launches["bn_sums_grad"],
               moments_launches=train_launches["bn_moments"],
               moments_grad_launches=train_launches["bn_moments_grad"],
               sums_ms=bn_stats["sums_ms"]),
         "replaces": None},
        row("image_motion_transform", "video_transform.cu",
            "resample_pallas.py:131", "train_sun", sun_launches, k4),
        # the SUN path's other kernels run at the video training path's
        # shapes (16 clips a step; 16 one-clip videos an evaluation
        # dispatch): its launches beside those measurements
        row("video_transform", "video_transform.cu", k1_at, "train_sun",
            sun_launches, k1_train),
        row("bn_apply_relu", "bn_apply_relu.cu", k2_at, "train_sun",
            sun_launches, k2_train),
        row("bn_apply_relu_bwd", "bn_apply_relu.cu", "bn_pallas.py:173",
            "train_sun", sun_launches, k2b),
        row("temporal_conv3", "temporal_conv.cu", "temporal_conv.py:76",
            "op", k3_launches, k3),
        # the P8 paths: C3D (no BN: K1 only) at the video training and
        # serving shapes, r3d_18 + linear at its own epilogue shapes, remat
        # and --fixconvs at r2plus1d_18's training shapes
        row("video_transform", "video_transform.cu", k1_at, "train_c3d",
            c3d_launches, k1_train),
        row("video_transform", "video_transform.cu", k1_at, "serve_c3d",
            serve_c3d_launches, k1),
        row("video_transform", "video_transform.cu", k1_at,
            "train_r3d_linear", r3d_launches, k1_train),
        row("bn_apply_relu", "bn_apply_relu.cu", k2_at, "train_r3d_linear",
            r3d_launches, k2_r3d),
        row("bn_apply_relu_bwd", "bn_apply_relu.cu", "bn_pallas.py:173",
            "train_r3d_linear", r3d_launches, k2b_r3d),
        *[row(name, source, at, f"train_remat_{remat}",
              remat_launches[remat], rec)
          for remat in REMATS for name, source, at, rec in (
              ("video_transform", "video_transform.cu", k1_at, k1_train),
              ("bn_apply_relu", "bn_apply_relu.cu", k2_at, k2_train),
              ("bn_apply_relu_bwd", "bn_apply_relu.cu", "bn_pallas.py:173",
               k2b))],
        row("video_transform", "video_transform.cu", k1_at, "train_fixconvs",
            fix_launches, k1_train),
        row("bn_apply_relu", "bn_apply_relu.cu", k2_at, "train_fixconvs",
            fix_launches, k2_train),
        # X3D-M (phase 15b): one step's launches, each kernel held and
        # timed at its train cell's 64 clips of 16x224x224
        row("video_transform", "video_transform.cu", k1_at, "train_x3d",
            x3d_launches, k1_x3d),
        row("bn_apply_relu", "bn_apply_relu.cu", k2_at, "train_x3d",
            x3d_launches, k2_x3d),
        row("bn_apply_relu_bwd", "bn_apply_relu.cu", "bn_pallas.py:173",
            "train_x3d", x3d_launches, k2b_x3d),
        {**row("bn_sums", "bn_stats.cu", "", "train_x3d", x3d_launches,
               bn_x3d, clips=bn_x3d["clips"],
               grad_launches=x3d_launches["bn_sums_grad"],
               moments_launches=x3d_launches["bn_moments"],
               moments_grad_launches=x3d_launches["bn_moments_grad"],
               sums_ms=bn_x3d["sums_ms"]),
         "replaces": None},
        # X3D-M's channel-wise convs (no TPU kernel: the JAX package has no
        # X3D): the forward's launches in the counted step beside the data
        # and weight gradients', each pass's ms per step at 64 clips
        {**row("channelwise_fwd", "channelwise_conv.cu", "", "train_x3d",
               x3d_launches, dwconv_x3d, clips=dwconv_x3d["clips"],
               dgrad_launches=x3d_launches["channelwise_dgrad"],
               wgrad_launches=x3d_launches["channelwise_wgrad"],
               **{k: dwconv_x3d[k] for k in ("fwd_ms", "dgrad_ms",
                                             "wgrad_ms")}),
         "replaces": None},
        # data parallelism: a group of one at the training path's shapes;
        # two processes at DP_LOCAL clips each, launches counted in process
        # 0 (process 1's are held equal to them)
        *[row(name, source, at, path, launches, rec)
          for path, launches, recs in (
              ("train_dp_world1", dp1_launches, (k1_train, k2_train, k2b)),
              ("train_dp_2rank", dp2_launches, (k1_dp, k2_dp, k2b_dp)),
              ("cli_dp_2rank", cli_dp_launches, (k1_dp, k2_dp, k2b_dp)))
          for (name, source, at), rec in zip((
              ("video_transform", "video_transform.cu", k1_at),
              ("bn_apply_relu", "bn_apply_relu.cu", k2_at),
              ("bn_apply_relu_bwd", "bn_apply_relu.cu", "bn_pallas.py:173")),
              recs)],
        # CUDA graphs of the train step: launches through the wrappers in
        # the two-epoch run (K1 every batch; K2 in the eager first group
        # and the capture, none in a replay), and K2's kernel nodes in one
        # replay of GRAPH_K steps
        row("video_transform", "video_transform.cu", k1_at, "train_graphs",
            graph_launches, k1_train),
        *[row(name, "bn_apply_relu.cu", at, "train_graphs", graph_launches,
              rec, replay_kernels=RECORD["train_graphs"]["graph"]["nodes"][
                  name])
          for name, at, rec in (("bn_apply_relu", k2_at, k2_train),
                                ("bn_apply_relu_bwd", "bn_pallas.py:173",
                                 k2b))],
        # the head's tensor parallelism: a process of the 1 x TP grid steps
        # on the whole batch of TRAIN_BS clips, the train row's shapes;
        # launches counted in process 0 (process 1's are held equal)
        *[row(name, source, at, "train_tp_2rank", tp_launches, rec)
          for (name, source, at), rec in zip((
              ("video_transform", "video_transform.cu", k1_at),
              ("bn_apply_relu", "bn_apply_relu.cu", k2_at),
              ("bn_apply_relu_bwd", "bn_apply_relu.cu", "bn_pallas.py:173")),
              (k1_train, k2_train, k2b))],
        # the engine over replicas (phase 21): launches in one request
        # through serve_forever, K1 and K2 forward at a replica's shapes on
        # the last replica's device
        row("video_transform", "video_transform.cu", k1_at,
            "serve_replicas", replica_launches, k1_rep),
        row("bn_apply_relu", "bn_apply_relu.cu", k2_at, "serve_replicas",
            replica_launches, k2_rep),
        # the dry run (phase 22), float32 at a process's shapes; launches
        # counted in process 0
        row("bn_apply_relu", "bn_apply_relu.cu", k2_at, "dryrun",
            dry_launches, k2_dry),
        row("bn_apply_relu_bwd", "bn_apply_relu.cu", "bn_pallas.py:173",
            "dryrun", dry_launches, k2b_dry),
        # --save_samples (phase 23): the train row's shapes; K1 also makes
        # the dump's batch
        *[row(name, source, at, "cli_save_samples", p11b_launches, rec)
          for (name, source, at), rec in zip((
              ("video_transform", "video_transform.cu", k1_at),
              ("bn_apply_relu", "bn_apply_relu.cu", k2_at),
              ("bn_apply_relu_bwd", "bn_apply_relu.cu", "bn_pallas.py:173")),
              (k1_train, k2_train, k2b))],
    ]}
    check(all(k["launches"] > 0 for k in kernels["kernels"]),
          f"a kernel was never launched on a main path: {kernels}")
    say("[phases] host seconds: " + ", ".join(
        f"{name} {sec:.1f}" for name, sec in RECORD["phase_seconds"].items())
        + f"; in all {_LAP[-1] - _LAP[0]:.1f}")
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)),
                    exist_ok=True)
        with open(args.json, "w") as f:
            json.dump({**RECORD, **kernels}, f, indent=1, default=str)
    say(smi)
    say(json.dumps(kernels))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
