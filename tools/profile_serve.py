#!/usr/bin/env python3
"""Where the PyTorch port's serving path spends its time, on one GPU.

    python tools/profile_serve.py [--json PATH]

The configuration of chip_smoke.py's serve phase: r2plus1d_18 + mlp head at
full width, 4 clips x 16x112x112, bf16, seeded random weights, the port's
InferenceEngine with max_batch 32 (buckets 8/16/32), 16 seeded synthetic
64x240x320 .npy clips. Three measurements, each printed as it is taken:

  1. trace: torch.profiler around one bf16 forward at bucket 8 (after a
     warm-up): the device time of every kernel, summed by name and by kind
     (K2, conv, cuDNN channel padding, memset, other), beside the forward's
     host wall time;
  2. convs: each conv of the model alone at its bucket-8 input (bf16,
     channels-last-3d, CUDA-event median), and the whole bucket-8 forward,
     with cuDNN autotuning (torch.backends.cudnn.benchmark) off and then
     on, each on a thread of its own;
  3. dispatch: one dispatch at each bucket split into phases on the host
     clock (median of 5 after one warm-up): decode + pack, pinned staging +
     H2D + K1, forward, ranking; and the pinned staging copy and the H2D
     copy of the bucket-16 canvas alone.

Needs an NVIDIA GPU and prints the card's name and power limit first.
"""

from __future__ import annotations

import argparse
import concurrent.futures as cf
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_CLIPS, CLIP_LEN, SIZE, MAX_BATCH = 4, 16, 112, 32
N_VIDEOS, FRAMES, HEIGHT, WIDTH = 16, 64, 240, 320
REPS = 5
DEVICE = "cuda:0"


def kind(name: str) -> str:
    low = name.lower()
    if "bn_apply_relu" in low:
        return "K2"
    if "video_transform" in low:
        return "K1"
    if "padding" in low:
        return "channel padding"
    if "memset" in low:
        return "memset"
    if any(k in low for k in ("conv", "xmma", "implicit", "fprop", "cudnn",
                              "cutlass", "gemm", "wgrad", "dgrad")):
        return "conv"
    return "other"


def median_ms(fn, reps=10):
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


def trace_forward(model, x):
    import torch
    from torch.profiler import ProfilerActivity, profile

    from zeroshotvideoclassification_tpu_torch.train import eval_step

    eval_step(model, x)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eval_step(model, x)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name, by_kind = {}, {}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = e.time_range.elapsed_us()
        by_name[e.name] = by_name.get(e.name, 0.0) + us / 1e3
        by_kind[kind(e.name)] = by_kind.get(kind(e.name), 0.0) + us / 1e3
    device_ms = sum(by_kind.values())
    print(f"[trace] bf16 forward at bucket 8: host wall {wall_ms:.2f} ms, "
          f"device kernels {device_ms:.2f} ms", flush=True)
    if not by_kind:
        print("[trace] the profiler saw no device kernel", flush=True)
    for k, ms in sorted(by_kind.items(), key=lambda kv: -kv[1]):
        print(f"[trace]   {k}: {ms:.3f} ms ({100 * ms / device_ms:.1f}%)",
              flush=True)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    for name, ms in top:
        print(f"[trace]   {ms:8.3f} ms  {name[:110]}", flush=True)
    return {"wall_ms": wall_ms, "device_ms": device_ms, "by_kind": by_kind,
            "top_kernels": top}


def in_fresh_thread(fn):
    """fn() on a new thread. PyTorch keeps the cuDNN algorithm it chose for
    each conv shape in a table per thread, and uses an entry found there
    whatever torch.backends.cudnn.benchmark says now."""
    with cf.ThreadPoolExecutor(max_workers=1) as ex:
        return ex.submit(fn).result()


def time_convs(model, x):
    import torch
    from torch import nn

    from zeroshotvideoclassification_tpu_torch.train import eval_step

    shapes = {}

    def grab(mod, args):
        shapes[mod] = tuple(args[0].shape)

    convs = {name: m for name, m in model.named_modules()
             if isinstance(m, nn.Conv3d)}
    hooks = [m.register_forward_pre_hook(grab) for m in convs.values()]
    try:
        eval_step(model, x)
    finally:
        for h in hooks:
            h.remove()
    rows = {name: {"input": list(shapes[m])} for name, m in convs.items()}
    forward = {}

    def measure(key):
        for name, m in convs.items():
            xi = torch.randn(shapes[m], device=x.device).to(
                m.weight.dtype).contiguous(
                    memory_format=torch.channels_last_3d)
            with torch.inference_mode():
                rows[name][key] = median_ms(lambda: m(xi))
            del xi
        forward[key] = median_ms(lambda: eval_step(model, x))

    for bench in (False, True):
        torch.backends.cudnn.benchmark = bench
        in_fresh_thread(lambda: measure(
            "autotuned_ms" if bench else "default_ms"))
    torch.backends.cudnn.benchmark = True
    for key in ("default_ms", "autotuned_ms"):
        total = sum(r[key] for r in rows.values())
        slow = sorted(rows.items(), key=lambda kv: -kv[1][key])[:4]
        print(f"[convs] cudnn.benchmark={key == 'autotuned_ms'}: bucket-8 "
              f"forward {forward[key]:.2f} ms; its {len(rows)} convs alone "
              f"sum to {total:.2f} ms; slowest "
              + "; ".join(f"{n} {r['input']} {r[key]:.3f} ms"
                          for n, r in slow), flush=True)
    return {"forward_ms": forward, "convs": rows}


def time_dispatch(engine, paths):
    import torch

    from zeroshotvideoclassification_tpu_torch.config import transform_dtype
    from zeroshotvideoclassification_tpu_torch.data.pipeline import (
        device_batch,
    )
    from zeroshotvideoclassification_tpu_torch.train import eval_step

    out = {}
    dt = transform_dtype(engine.config)
    for bucket in engine.batch_buckets:
        sub = (paths * (bucket // len(paths) + 1))[:bucket]
        phases = {"pack": [], "h2d_k1": [], "forward": [], "rank": []}
        for rep in range(REPS + 1):
            t0 = time.perf_counter()
            packed = engine.pack_paths(sub)
            t1 = time.perf_counter()
            batch = device_batch(packed["hb"], N_CLIPS, CLIP_LEN, dt,
                                 engine.device)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            emb = eval_step(engine.model, batch["x"])
            torch.cuda.synchronize()
            t3 = time.perf_counter()
            engine._distances(emb.float().cpu().numpy())
            t4 = time.perf_counter()
            if rep:  # the first round warms this thread's cuDNN table
                for v, secs in zip(phases.values(), (t1 - t0, t2 - t1,
                                                     t3 - t2, t4 - t3)):
                    v.append(secs * 1e3)
        out[bucket] = {k: statistics.median(v) for k, v in phases.items()}
        print(f"[dispatch] bucket {bucket}: " + ", ".join(
            f"{k} {v:.2f} ms" for k, v in out[bucket].items()), flush=True)
        if bucket == 16:
            canvas = packed["hb"].canvas
            src = torch.from_numpy(canvas)
            pin = statistics.median(
                _host_ms(lambda: src.pin_memory()) for _ in range(REPS))
            pinned = src.pin_memory()
            h2d = statistics.median(_host_ms(lambda: (
                pinned.to(engine.device, non_blocking=True),
                torch.cuda.synchronize())) for _ in range(REPS))
            out["canvas16"] = {"MB": canvas.nbytes / 1e6, "pin_ms": pin,
                               "h2d_ms": h2d}
            print(f"[dispatch] bucket-16 canvas {canvas.nbytes / 1e6:.1f} "
                  f"MB: pinned staging {pin:.2f} ms, H2D {h2d:.2f} ms "
                  f"({canvas.nbytes / 1e6 / h2d:.1f} GB/s)", flush=True)
    return out


def _host_ms(fn):
    t0 = time.perf_counter()
    fn()
    return (time.perf_counter() - t0) * 1e3


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--json", default=None, help="also write the numbers here")
    args = p.parse_args(argv)

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("profile_serve: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from torch_helpers import synthetic_clip
    from zeroshotvideoclassification_tpu_torch.serve import InferenceEngine

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0].strip()
    print(smi, flush=True)
    dev = torch.device(DEVICE)
    record = {"card": smi}
    with tempfile.TemporaryDirectory(prefix="profile_serve_") as tmp:
        paths = []
        for k in range(N_VIDEOS):
            path = os.path.join(tmp, f"video{k:02d}.npy")
            np.save(path, synthetic_clip(k, FRAMES, HEIGHT, WIDTH))
            paths.append(path)
        embed = np.random.default_rng(0).normal(
            size=(N_VIDEOS, 300)).astype(np.float32)
        engine = InferenceEngine(
            [f"c{k}" for k in range(N_VIDEOS)], embed, network="r2plus1d_18",
            head="mlp", weights=None, n_clips=N_CLIPS, clip_len=CLIP_LEN,
            size=SIZE, max_batch=MAX_BATCH, compute_dtype="bfloat16",
            device=dev)
        try:
            x = torch.rand((8, N_CLIPS, CLIP_LEN, SIZE, SIZE, 3),
                           device=dev).sub_(0.5).to(torch.bfloat16)
            record["trace"] = trace_forward(engine.model, x)
            record["convs"] = time_convs(engine.model, x)
            del x
            record["dispatch"] = time_dispatch(engine, paths)
        finally:
            engine.close()
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)),
                    exist_ok=True)
        with open(args.json, "w") as f:
            json.dump(record, f, indent=1, default=str)
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
