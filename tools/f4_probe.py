#!/usr/bin/env python3
"""Captures of the train step's CUDA graphs under memory ballast: where a
capture fails, which conv it was in and why.

    python3 tools/f4_probe.py [--levels 0.25,1,2,4,8] [--dtype bfloat16]
                              [--cache keep|empty] [--json PATH]
                              [--log_dir DIR] [--tree PATH] [--window]

For each level L (GiB), one fresh process builds chip_smoke.py's training
Experiment (r2plus1d_18, 16 clips of 16x112x112, --steps_per_call 4),
takes TRAIN_WARMUP eager steps (cuDNN's autotuning fills its plan cache;
the caching allocator keeps the step's blocks), then allocates a ballast
tensor that leaves L GiB of the card free (--cache empty: after
torch.cuda.empty_cache(), so the step's cached blocks are gone too) and
runs two groups of 4 steps: the first eager then captured, the second a
replay. Each level reports how it ended (completed, OutOfMemoryError or
another error with its message), which graph was being captured (the
4-step one or the one-step one), the conv module entered last, the
allocator's count of out-of-memory events during the groups (cuDNN
catches the OOM of a cached plan's workspace and searches again), the
failed allocation's size from torch.cuda.memory's history, and the tail
of cuDNN's own log (CUDNN_LOGLEVEL_DBG=2: warnings and errors) and of
PyTorch's cuDNN v8 debug output (TORCH_CUDNN_V8_API_DEBUG=1). --tree PATH
runs the port and chip_smoke.py of another checkout (a parent tree).
--window first traces one run at 8 GiB free (every segment the allocator
takes from CUDA (cudaMalloc) during the groups, with the C++ stack that asked for
it), then runs the levels at which the first four of those segments that
a cuDNN plan's workspace asked for (run_conv_plan on the stack) can no
longer be allocated: half of each one fits. Needs an NVIDIA GPU.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GIB = 2 ** 30
K = 4


def tail(path, n=40):
    try:
        with open(path, errors="replace") as f:
            return f.read().splitlines()[-n:]
    except OSError:
        return []


def describe(event):
    """An allocator event of torch.cuda.memory's history: its size, the
    stream, the first ATen or cuDNN frame of its C++ stack, the first frame
    of this repository's code, and whether a cuDNN plan's workspace asked
    for it (run_conv_plan on the stack)."""
    frames = [f"{f.get('name', '')} ({os.path.basename(f.get('filename', ''))}"
              f":{f.get('line')})" for f in (event.get("frames") or [])]
    aten = [f for f in frames if "at::native" in f or "cudnn" in f.lower()]
    ours = [f for f in frames if "zeroshotvideoclassification" in f]
    return {"size": event.get("size"), "stream": event.get("stream"),
            "device_free": event.get("device_free"),
            "workspace": any("run_conv_plan" in f or "Conv_v8" in f
                             for f in frames),
            "op": aten[0] if aten else None, "ours": ours[0] if ours else None}


def at_capture():
    """The allocator as a capture begins: GiB allocated and reserved, and
    the largest live blocks (outside the ballast) with the stacks that
    allocated them."""
    import torch

    blocks = [dict(b, stream=seg.get("stream"))
              for seg in torch.cuda.memory._snapshot()["segments"]
              for b in seg["blocks"] if b["state"] == "active_allocated"]
    blocks.sort(key=lambda b: -b["size"])
    return {"allocated_GiB": torch.cuda.memory_allocated() / GIB,
            "reserved_GiB": torch.cuda.memory_reserved() / GIB,
            "live_blocks": len(blocks),
            "largest": [describe(b) for b in blocks[1:9]]}


def child(args):
    """One level in this process: -> its record as JSON on the out path."""
    import torch

    import chip_smoke as cs
    from zeroshotvideoclassification_tpu_torch.models import layers as L

    dev = torch.device("cuda:0")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.benchmark = True
    rec = {"level_GiB": args.level, "cache": args.cache, "dtype": args.dtype}
    with tempfile.TemporaryDirectory(prefix="f4_probe_") as tmp:
        exp, host, ce = cs.experiment(cs.cli_argv(
            tmp, dev, args.dtype, cs.TRAIN_BS, cs.TRAIN_BS,
            "--steps_per_call", str(K)), dev)
        names = {id(m): n for n, m in exp.model.named_modules()}
        last = {}
        conv_forward = L.Conv3d.forward

        def traced(self, x):
            last.update(module=names.get(id(self)), x=list(x.shape),
                        w=list(self.weight.shape), dtype=str(x.dtype))
            return conv_forward(self, x)

        L.Conv3d.forward = traced
        captures = []
        begin = torch.cuda.CUDAGraph.capture_begin

        def counted_begin(self, *a, **kw):
            captures.append(len(captures) + 1)
            if len(captures) == 1:  # what the default pool holds then
                rec["at_capture"] = at_capture()
            return begin(self, *a, **kw)

        torch.cuda.CUDAGraph.capture_begin = counted_begin
        b = cs.to_card(exp, host)
        batch = (b["x"], b["z"], b["label"], b["weight"])
        rng = exp.rng.manual_seed(0)
        for _ in range(cs.TRAIN_WARMUP):
            exp.train_step(*batch, ce, rng)
        torch.cuda.synchronize()
        rec["eager_peak_GiB"] = torch.cuda.max_memory_allocated() / GIB
        rec["reserved_before_GiB"] = torch.cuda.memory_reserved() / GIB
        if args.cache == "empty":
            torch.cuda.empty_cache()
        free, total = torch.cuda.mem_get_info()
        take = max(free - int(args.level * GIB), 0) // 2 ** 21 * 2 ** 21
        ballast = torch.empty(take, dtype=torch.uint8, device=dev)
        rec["ballast_GiB"] = take / GIB
        rec["free_after_ballast_GiB"] = torch.cuda.mem_get_info()[0] / GIB
        scan = exp.scan_step
        for k in range(K):
            scan.stage(k, *batch)
        ooms = torch.cuda.memory_stats().get("num_ooms", 0)
        torch.cuda.memory._record_memory_history(max_entries=200000)
        t0 = time.perf_counter()
        try:
            m = scan.run(K, ce, rng)
            m = scan.run(K, ce, rng)
            torch.cuda.synchronize()
            rec["outcome"] = "completed"
            rec["losses"] = m["loss"].tolist()
            rec["capture_s"] = scan.captured["seconds"]
        except BaseException as e:  # noqa: BLE001  (what ended it is the result)
            rec["outcome"] = type(e).__name__
            rec["message"] = str(e)[:1500]
            rec["last_conv"] = dict(last)
        rec["seconds"] = time.perf_counter() - t0
        rec["captures_begun"] = len(captures)
        rec["num_ooms"] = torch.cuda.memory_stats().get("num_ooms", 0) - ooms
        snap = torch.cuda.memory._snapshot()
        torch.cuda.memory._record_memory_history(enabled=None)
        trace = [e for t in snap.get("device_traces", []) for e in t]
        rec["oom_events"] = [describe(e) for e in trace
                             if e.get("action") == "oom"][:8]
        if args.trace:
            # the segments the groups allocate, in order: an eager step
            # reuses the cached blocks, a capture's pool takes new ones
            rec["segments"] = [describe(e) for e in trace
                               if e.get("action") == "segment_alloc"]
        rec["reserved_after_GiB"] = torch.cuda.memory_reserved() / GIB
        del ballast
    with open(args.out, "w") as f:
        json.dump(rec, f, indent=1, default=str)
    return 0


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--levels", default="0.25,1,2,4,8")
    p.add_argument("--dtype", default="bfloat16")
    p.add_argument("--cache", default="keep", choices=("keep", "empty"))
    p.add_argument("--json", default=None)
    p.add_argument("--log_dir", default=None)
    p.add_argument("--tree", default=ROOT)
    p.add_argument("--window", action="store_true",
                   help="trace one capture at 8 GiB free, then run the "
                        "levels at which its first cuDNN workspace "
                        "segments cannot be allocated")
    p.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    p.add_argument("--trace", action="store_true", help=argparse.SUPPRESS)
    p.add_argument("--level", type=float, help=argparse.SUPPRESS)
    p.add_argument("--out", help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    tree = os.path.abspath(args.tree)
    sys.path[:0] = [tree, os.path.join(tree, "tests")]
    if args.child:
        return child(args)
    import torch

    if not torch.cuda.is_available():
        print("f4_probe: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    import chip_smoke as cs

    smi = cs.phase_env()
    cs.phase_build()
    log_dir = os.path.abspath(args.log_dir or tempfile.mkdtemp(
        prefix="f4_logs_"))
    os.makedirs(log_dir, exist_ok=True)
    out = {"tree": tree, "smi": smi, "levels": []}
    levels = [float(v) for v in args.levels.split(",")]
    if args.window:
        rec = run_level(args, tree, log_dir, 8.0, trace=True)
        out["trace"] = rec
        segs = rec.get("segments", [])
        cum, picks = 0, []
        for i, seg in enumerate(segs):
            if seg["workspace"] and seg["stream"] and len(picks) < 4:
                picks.append((i, cum, seg))
            cum += seg["size"] or 0
        cs.say(f"[f4] trace: {len(segs)} segments allocated in the groups "
               f"({cum / GIB:.3f} GiB), cuDNN workspace segments among "
               f"them: {sum(s['workspace'] for s in segs)}; picked "
               f"{[(i, round(c / GIB, 3), s['size'], s['op']) for i, c, s in picks]}")
        levels = [round((c + 0.5 * s["size"]) / GIB, 4) for _, c, s in picks]
        out["window"] = [{"index": i, "before": c, **s} for i, c, s in picks]
    for level in levels:
        rec = run_level(args, tree, log_dir, level)
        out["levels"].append(rec)
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)),
                    exist_ok=True)
        with open(args.json, "w") as f:
            json.dump(out, f, indent=1, default=str)
    cs.say(smi)
    return 0


def run_level(args, tree, log_dir, level, trace=False):
    """One level in a fresh process, with cuDNN's and PyTorch's cuDNN
    debug logs on. -> its record."""
    import chip_smoke as cs

    if True:
        tag = f"{args.dtype}_{args.cache}_{level:g}{'_trace' * trace}"
        res = os.path.join(log_dir, f"{tag}.json")
        cudnn_log = os.path.join(log_dir, f"{tag}.cudnn.log")
        stdout = os.path.join(log_dir, f"{tag}.stdout.log")
        env = dict(os.environ, PYTHONPATH=tree, CUDNN_LOGLEVEL_DBG="2",
                   CUDNN_LOGDEST_DBG=cudnn_log, TORCH_CUDNN_V8_API_DEBUG="1")
        t0 = time.perf_counter()
        with open(stdout, "w") as f:
            r = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--child",
                 "--tree", tree, "--level", str(level), "--dtype",
                 args.dtype, "--cache", args.cache, "--out", res]
                + ["--trace"] * trace,
                stdout=f, stderr=subprocess.STDOUT, env=env, timeout=600)
        rec = (json.load(open(res)) if os.path.exists(res)
               else {"level_GiB": level, "outcome": f"process rc {r.returncode}"})
        rec["process_s"] = time.perf_counter() - t0
        rec["cudnn_log_tail"] = tail(cudnn_log, 30)
        rec["stdout_tail"] = tail(stdout, 30)
        cs.say(f"[f4] {tag}: {rec.get('outcome')} "
               f"(captures begun {rec.get('captures_begun')}, OOM events "
               f"{rec.get('num_ooms')} {rec.get('oom_events')}, last conv "
               f"{rec.get('last_conv')}, free after ballast "
               f"{rec.get('free_after_ballast_GiB')}) "
               f"{str(rec.get('message', ''))[:400]}")
    return rec


if __name__ == "__main__":
    sys.exit(main())
