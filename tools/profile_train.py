#!/usr/bin/env python3
"""Where the PyTorch port's training step spends its time, on one GPU.

    python tools/profile_train.py [--json PATH] [--bs 16]

The configuration of chip_smoke.py's train phase: r2plus1d_18 + mlp head at
full width, batches of 16 clips of 16x112x112 from the synthetic dataset,
bf16 compute with float32 master weights, the objects the training CLI
builds (cli/main.Experiment). Three measurements, each printed as it is
taken:

  1. trace (taken last: once the profiler has run, every later launch of
     the process costs the host more): torch.profiler around two train
     steps on one device batch: the device time of every kernel, summed
     by name and by kind — convs forward / backward (data) / backward
     (weights), cuDNN's layout and padding kernels, K2 forward, K2 backward
     (both passes), reductions (the batch statistics' two means, pooling,
     the finiteness flag), elementwise (the statistics' casts, shifts and
     squares forward and backward, the weight casts, gradient sums), Adam's
     foreach kernels, K1, copies — beside the steps' host wall time;
  2. parts (after three warm-up steps): CUDA-event times of the forward, the backward and the
     optimizer step of one train step taken apart, and of the forward alone
     with the batch statistics replaced by the running ones (eval mode), so
     that what the statistics cost forward is their difference;
  3. feed: host decode + pack of one batch, and pinned staging + H2D + K1.

Needs an NVIDIA GPU and prints the card's name and power limit first.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WARMUP, TRACED = 3, 2
DEVICE = "cuda:0"


def kind(name: str) -> str:
    low = name.lower()
    if "bn_bwd" in low:
        return "K2 backward"
    if "bn_apply_relu" in low:
        return "K2 forward"
    if "video_transform" in low:
        return "K1"
    if "multi_tensor_apply" in low:
        return "Adam (foreach)"
    if "memcpy" in low or "memset" in low:
        return "copies and memsets"
    if "wgrad" in low:
        return "conv backward (weights)"
    if "dgrad" in low:
        return "conv backward (data)"
    if any(k in low for k in ("padding", "nchwtonhwc", "nhwctonchw",
                              "transpose", "tensortransform")):
        return "cuDNN layout and padding"
    if any(k in low for k in ("fprop", "xmma", "implicit", "cudnn",
                              "cutlass", "gemm", "conv")):
        return "conv forward and other GEMMs"
    if "reduce" in low:
        return "reductions"
    if "elementwise" in low:
        return "elementwise"
    return "other"


def event_ms(fn):
    import torch

    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    out = fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b), out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--json", default=None)
    p.add_argument("--bs", type=int, default=16)
    args = p.parse_args(argv)
    sys.path.insert(0, ROOT)

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("profile_train: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    from zeroshotvideoclassification_tpu_torch.cli import main as train_cli
    from zeroshotvideoclassification_tpu_torch.config import (
        config_from_namespace,
        transform_dtype,
    )
    from zeroshotvideoclassification_tpu_torch.data.datasets import (
        build_datasets,
    )
    from zeroshotvideoclassification_tpu_torch.data.pipeline import (
        HostPipeline,
        device_batch,
    )
    from zeroshotvideoclassification_tpu_torch.train import masked_mse

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0].strip()
    print(smi, flush=True)
    dev = torch.device(DEVICE)
    record = {"nvidia_smi": smi, "bs": args.bs}
    with tempfile.TemporaryDirectory(prefix="profile_train_") as tmp:
        ns = train_cli.build_arg_parser().parse_args([
            "--dataset", "synthetic", "--network", "r2plus1d_18", "--bs",
            str(args.bs), "--train_samples", str(4 * args.bs),
            "--save_path", tmp, "--no-progressbar", "--nopretrained"])
        cfg = config_from_namespace(ns)
        datasets = build_datasets(cfg, None)
        exp = train_cli.Experiment(cfg, datasets, device=dev)
        table = datasets["training"][0]
        pipe = HostPipeline(table, cfg, args.bs, seed=0)

        # 3. feed
        feed = []
        for host in pipe:
            t0 = time.perf_counter()
            batch = device_batch(host, table.n_clips, cfg.clip_len,
                                 transform_dtype(cfg), dev)
            torch.cuda.synchronize()
            feed.append((time.perf_counter() - t0) * 1e3)
        t0 = time.perf_counter()
        n_batches = sum(1 for _ in pipe)
        pack_ms = (time.perf_counter() - t0) * 1e3 / n_batches
        record["feed"] = {"pack_ms": pack_ms,
                          "h2d_k1_ms": statistics.median(feed[1:])}
        print(f"[feed] host decode + pack of {args.bs} synthetic clips: "
              f"{pack_ms:.1f} ms per batch; pinned staging + H2D + K1: "
              f"{record['feed']['h2d_k1_ms']:.2f} ms", flush=True)

        ce = torch.from_numpy(np.asarray(table.class_embed,
                                         np.float32)).to(dev)
        step_args = (batch["x"], batch["z"], batch["label"],
                     batch["weight"], ce)
        for _ in range(WARMUP):
            exp.train_step(*step_args)
        torch.cuda.synchronize()

        # 2. parts
        model, opt = exp.model, exp.optimizer
        x, z, _, w, _ = step_args
        parts = {"forward": [], "backward": [], "optimizer": [],
                 "step": []}
        for _ in range(5):
            model.train()
            opt.zero_grad(set_to_none=True)
            torch.cuda.synchronize()
            f_ms, emb = event_ms(lambda: model(x))
            loss = masked_mse(emb, z, w)
            b_ms, _ = event_ms(loss.backward)
            o_ms, _ = event_ms(opt.step)
            s_ms, _ = event_ms(lambda: exp.train_step(*step_args))
            for k, v in zip(parts, (f_ms, b_ms, o_ms, s_ms)):
                parts[k].append(v)
        model.eval()
        fe = []
        for _ in range(5):
            with torch.no_grad():
                fe.append(event_ms(lambda: model(x))[0])
        model.train()
        med = {k: statistics.median(v) for k, v in parts.items()}
        med["forward_eval_mode"] = statistics.median(fe)
        torch.cuda.reset_peak_memory_stats()
        exp.train_step(*step_args)
        torch.cuda.synchronize()
        med["peak_GiB"] = torch.cuda.max_memory_allocated() / 2 ** 30
        record["parts_ms"] = med
        print(f"[parts] forward {med['forward']:.2f} ms (with running "
              f"statistics and no autograd: {med['forward_eval_mode']:.2f}),"
              f" backward {med['backward']:.2f} ms, optimizer "
              f"{med['optimizer']:.2f} ms; whole step {med['step']:.2f} ms ="
              f" {args.bs / med['step'] * 1e3:.1f} clips/s; peak memory "
              f"{med['peak_GiB']:.2f} GiB  ({smi})", flush=True)
        # 1. trace
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(TRACED):
                exp.train_step(*step_args)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3 / TRACED
        by_name, by_kind, count = {}, {}, {}
        for e in prof.events():
            if (e.device_type != torch.autograd.DeviceType.CUDA
                    or e.name.startswith("Optimizer.")):  # an annotation
                continue
            ms = e.time_range.elapsed_us() / 1e3 / TRACED
            by_name[e.name] = by_name.get(e.name, 0.0) + ms
            by_kind[kind(e.name)] = by_kind.get(kind(e.name), 0.0) + ms
            count[kind(e.name)] = count.get(kind(e.name), 0) + 1
        device_ms = sum(by_kind.values())
        print(f"[trace] one bf16 train step of {args.bs} clips: host wall "
              f"{wall_ms:.2f} ms (under the profiler), device kernels "
              f"{device_ms:.2f} ms", flush=True)
        if not by_kind:
            print("[trace] the profiler saw no device kernel", flush=True)
        for k, ms in sorted(by_kind.items(), key=lambda kv: -kv[1]):
            print(f"[trace]   {k}: {ms:.3f} ms ({100 * ms / device_ms:.1f}%)"
                  f" in {count[k] // TRACED} launches", flush=True)
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:25]
        for name, ms in top:
            print(f"[trace]   {ms:8.3f} ms  {kind(name):28s} {name[:90]}",
                  flush=True)
        record["trace"] = {"wall_ms": wall_ms, "device_ms": device_ms,
                           "by_kind": by_kind, "launches": {
                               k: v // TRACED for k, v in count.items()},
                           "top_kernels": top}

        exp.log.close()
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)),
                    exist_ok=True)
        with open(args.json, "w") as f:
            json.dump(record, f, indent=1, default=str)
    return 0


if __name__ == "__main__":
    sys.exit(main())
