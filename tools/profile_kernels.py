#!/usr/bin/env python3
"""K1 and K2 forward of the PyTorch port timed through their public
wrappers, on one GPU, for this checkout or another one (a parent commit
unpacked with `git archive`), so that two trees compare on one card.

    python tools/profile_kernels.py [--tree PATH] [--json PATH] [--k1_plans]

--tree PATH imports zeroshotvideoclassification_tpu_torch (and the test
helpers) from the checkout at PATH; the default is this one. Shapes are the
main paths' own (bf16 outputs):

  K1   the serving batch at bucket 8 (8 videos x 4 clips: an 8x64x226x226x3
       canvas from data/pipeline.host_batch over seeded 64x240x320 clips)
       and a 16-clip training-sized batch (16x16x226x226x3, 1 clip a
       video);
  K2   every epilogue of r2plus1d_18's bf16 forward at 32 clips (serving,
       bucket 8) and at 16 clips (training), each as often as a forward
       calls it, with seeded statistics.

For each: the wrapper (median of one call between two CUDA events), the
wrapper queued (a run of 20 calls between two events, per call: the queue
hides the host while a call's host time is shorter than its device time)
and the device time in a torch.profiler trace of such a run (per call).
K2's numbers are sums over one forward. --k1_plans also times K1's launch
alone (its output allocated once, a run of 20 launches between two events)
under each plan ops/resample_cuda.k1_plan makes at band heights 4 to 32,
each output checked equal to the chosen plan's. Needs an NVIDIA GPU; prints the
card's name and power limit first.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RUN = 20
DEVICE = "cuda:0"


def event_ms(fn, calls=1, reps=10):
    """Median over `reps` of the device time of `calls` calls of fn()
    queued between two CUDA events, per call (after one warm-up run)."""
    import torch

    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(calls):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / calls)
    return statistics.median(times)


def trace_ms(fn, name):
    """Device time per call of the kernels whose name holds `name`, in a
    torch.profiler trace of RUN calls; -> (ms, kernels seen per call)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(RUN):
            fn()
        torch.cuda.synchronize()
    us, n = 0.0, 0
    for e in prof.events():
        if (e.device_type == torch.autograd.DeviceType.CUDA
                and name in e.name):
            us += e.time_range.elapsed_us()
            n += 1
    return us / 1e3 / RUN, n / RUN


def times(fn, name):
    ms_trace, kernels = trace_ms(fn, name)
    return {"wrapper_ms": event_ms(fn), "queued_ms": event_ms(fn, RUN, 5),
            "trace_ms": ms_trace, "kernels_per_call": kernels}


def k1_batches(tmp, dev):
    """{name: (canvas, y0, y1, wy, x0, x1, wx)} on the card."""
    import numpy as np
    import torch

    from torch_helpers import synthetic_clip
    from zeroshotvideoclassification_tpu_torch.config import Config
    from zeroshotvideoclassification_tpu_torch.data.pipeline import host_batch

    paths = []
    for k in range(8):
        p = os.path.join(tmp, f"video{k}.npy")
        np.save(p, synthetic_clip(k, 64, 240, 320))
        paths.append(p)
    out = {}
    for name, n_clips, bucket in (("serve bucket 8", 4, 8),
                                  ("train batch of 16", 1, 16)):
        cfg = Config(size=112, clip_len=16, n_clips=n_clips)
        hb = host_batch((paths * 2)[:bucket], cfg, bucket, ["c"],
                        np.ones((1, 300), np.float32))
        args = [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in
                (hb.canvas, hb.y0, hb.y1, hb.wy, hb.x0, hb.x1, hb.wx)]
        for j in (4, 5, 6):  # every other sample flipped
            args[j][1::2] = args[j][1::2].flip(1)
        out[name] = args
    return out


def k1_plans(name, args, dev):
    """K1's launch alone under the plan k1_plan makes at each band height."""
    import torch

    from zeroshotvideoclassification_tpu_torch.ops import resample_cuda as rc

    b, t, hc, wc, _ = args[0].shape
    s = args[1].shape[1]
    own = rc.transform_plan
    chosen = own(b, t, hc, wc, s, 2)
    want = rc.fused_video_transform_cuda(*args, out_dtype=torch.bfloat16)
    rows = []
    for band in (4, 8, 16, 32):
        plan = rc.k1_plan(b, t, hc, wc, s, 2, band)
        if plan is None:
            continue
        rc.transform_plan = lambda *a, plan=plan: plan
        try:  # transform_prepare takes this plan
            launch, out = rc.transform_prepare(*args,
                                               out_dtype=torch.bfloat16)
            ms = event_ms(launch, RUN, 5)
        finally:
            rc.transform_plan = own
        same = bool(torch.equal(out, want))
        rows.append({**plan, "ms": ms, "equal": same})
        print(f"[K1 plans] {name}: {band} rows a band, {plan['blocks']} "
              f"blocks, {plan['per_sm']} an SM, {plan['smem_bytes']} B "
              f"shared: launch alone {ms:.4f} ms, output "
              f"{'equal' if same else 'DIFFERS'}"
              + ("  <- chosen" if plan == chosen else ""), flush=True)
        if not same:
            raise RuntimeError(f"K1 under {plan} differs")
    return rows


def epilogue_calls(clips, dev):
    """{(shape [N,T,H,W,C], residual?, relu?): calls} of one bf16 forward
    of r2plus1d_18 at `clips` clips of 16x112x112 (chip_smoke.py's hooks on
    the timed tree's model)."""
    import torch

    from chip_smoke import epilogue_calls as hooked_calls
    from zeroshotvideoclassification_tpu_torch.cli.infer import load_model
    from zeroshotvideoclassification_tpu_torch.config import Config

    model, _ = load_model(Config(network="r2plus1d_18",
                                 compute_dtype="bfloat16"), None, dev)
    return hooked_calls(model, torch.zeros((clips, 1, 16, 112, 112, 3),
                                           device=dev, dtype=torch.bfloat16))


def k2_forward(clips, dev):
    import torch

    from zeroshotvideoclassification_tpu_torch.ops.bn_cuda import (
        bn_apply_relu_cuda,
    )

    g = torch.Generator(device=dev).manual_seed(0)
    total = {"wrapper_ms": 0.0, "queued_ms": 0.0, "trace_ms": 0.0,
             "kernels_per_call": 0.0, "epilogues": 0}
    for (shape, res, relu), n in sorted(epilogue_calls(clips, dev).items()):
        c = shape[-1]
        stats = [torch.rand(c, device=dev, generator=g) * 1.5 + 0.5,
                 torch.randn(c, device=dev, generator=g),
                 torch.randn(c, device=dev, generator=g),
                 torch.rand(c, device=dev, generator=g) * 2.7 + 0.3]
        x = torch.randn(shape, device=dev, generator=g).bfloat16()
        r = torch.randn(shape, device=dev, generator=g).bfloat16() if res \
            else None
        t = times(lambda: bn_apply_relu_cuda(x, *stats, r, relu),
                  "bn_apply_relu")
        print(f"[K2 fwd] {clips} clips {'x'.join(map(str, shape))} "
              f"res={int(res)} relu={int(relu)} x{n}: wrapper "
              f"{t['wrapper_ms']:.4f} ms, queued {t['queued_ms']:.4f} ms, "
              f"trace {t['trace_ms']:.4f} ms", flush=True)
        for k in ("wrapper_ms", "queued_ms", "trace_ms", "kernels_per_call"):
            total[k] += n * t[k]
        total["epilogues"] += n
        del x, r
    return total


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--tree", default=ROOT,
                   help="the checkout whose port is timed (default: this)")
    p.add_argument("--json", default=None, help="also write the numbers here")
    p.add_argument("--k1_plans", action="store_true",
                   help="also time K1 under every plan k1_plan makes")
    args = p.parse_args(argv)
    tree = os.path.abspath(args.tree)
    sys.path[:0] = [tree, os.path.join(tree, "tests"), ROOT]

    import torch

    if not torch.cuda.is_available():
        print("profile_kernels: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0].strip()
    import zeroshotvideoclassification_tpu_torch as port
    from zeroshotvideoclassification_tpu_torch.ops.resample_cuda import (
        fused_video_transform_cuda,
    )

    print(f"{smi}\n[tree] {os.path.dirname(port.__file__)}", flush=True)
    dev = torch.device(DEVICE)
    torch.backends.cudnn.benchmark = True
    record = {"nvidia_smi": smi, "tree": tree, "k1": {}, "k2_forward": {}}
    with tempfile.TemporaryDirectory(prefix="profile_kernels_") as tmp:
        for name, k1_args in k1_batches(tmp, dev).items():
            t = times(lambda: fused_video_transform_cuda(
                *k1_args, out_dtype=torch.bfloat16), "video_transform")
            record["k1"][name] = t
            print(f"[K1] {name} -> bfloat16: wrapper {t['wrapper_ms']:.4f} "
                  f"ms, queued {t['queued_ms']:.4f} ms, trace "
                  f"{t['trace_ms']:.4f} ms ({t['kernels_per_call']:.0f} "
                  f"kernel a call)  ({smi})", flush=True)
            if args.k1_plans:
                t["plans"] = k1_plans(name, k1_args, dev)
    for clips in (32, 16):
        t = k2_forward(clips, dev)
        record["k2_forward"][clips] = t
        print(f"[K2 fwd] one bf16 forward at {clips} clips, "
              f"{t['epilogues']} epilogues: wrapper {t['wrapper_ms']:.3f} "
              f"ms, queued {t['queued_ms']:.3f} ms, trace "
              f"{t['trace_ms']:.3f} ms ({t['kernels_per_call']:.0f} "
              f"kernels)  ({smi})", flush=True)
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)),
                    exist_ok=True)
        with open(args.json, "w") as f:
            json.dump(record, f, indent=1, default=str)
    return 0


if __name__ == "__main__":
    sys.exit(main())
