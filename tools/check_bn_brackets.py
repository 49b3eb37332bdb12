#!/usr/bin/env python3
"""The BN statistics' device brackets against the kernels of a trace.

    python3 tools/check_bn_brackets.py [--clips 64] [--steps 3] [--json PATH]

Runs R(2+1)D-18 + mlp train steps as the benchmark's train cell builds them
(bf16 convs over float32 masters, cuDNN's autotuning on, TF32 off,
channels-last), three to warm up and then `--steps` under torch.profiler,
and sets beside each other, per step:

  * the device ms of the CUDA-event brackets that utils/profiler.py keeps
    for `bn.stats` (models/layers.bn_statistics' forward) and
    `bn.stats.backward` (its gradient, between autograd hooks);
  * the device time of the kernels that bn_statistics' own ops launch: the
    forward's, linked by correlation id to the ops inside the trace's
    `zsv.bn.stats` ranges, and the backward's, linked to those forward ops
    by sequence number (autograd's `evaluate_function` events). The ops of
    ops/bn_stats.py are among them: the Functions' forward ops `_BNSums`
    and `_BNMoments` inside the range, their backward nodes
    `_BNSumsBackward` and `_BNMomentsBackward`;
  * the sums' own kernels (names with `bn_sums`: the forward's two stages,
    the gradient's kernel) and their launch counters.

Prints one JSON line (and writes it to --json): both sums a step, their
ratios, the kernel counts, the sums' ops, nodes, kernel ms and launches a
step, and the card's name. The brackets hold where each ratio is within
10% of 1. On the CPU (--device cpu, tiny sizes) it rehearses the linking;
there are no brackets and no kernels.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

WARMUP = 3


def _kernel_us(event) -> float:
    """Device time (us) of the kernels that `event` and the ops below it
    launched."""
    return (sum(k.duration for k in event.kernels)
            + sum(_kernel_us(c) for c in event.cpu_children))


def _below(event):
    yield event
    for c in event.cpu_children:
        yield from _below(c)


def link(events):
    """-> (forward us, backward us, forward ops, backward nodes) of the
    bn_statistics kernels among torch.profiler FunctionEvents; the ops
    (those with a sequence number, which several may share) and the nodes
    as lists of events."""
    from torch.autograd import DeviceType

    ranges = [e for e in events if e.name == "zsv.bn.stats"
              and e.device_type == DeviceType.CPU]
    fwd_us, ops = 0.0, []
    for r in ranges:
        fwd_us += _kernel_us(r)
        ops += [op for op in _below(r)
                if op is not r and op.sequence_nr >= 0]
    seqs = {(op.thread, op.sequence_nr) for op in ops}
    nodes = [e for e in events
             if e.name.startswith("autograd::engine::evaluate_function")
             and (e.fwd_thread, e.sequence_nr) in seqs]
    bwd_us = sum(_kernel_us(e) for e in nodes)
    return fwd_us, bwd_us, ops, nodes


def sums_kernel_us(events):
    """-> (forward us, backward us) of the kernels named `bn_sums` among
    the FunctionEvents' kernels: the sums' two stages, their gradient."""
    fwd = bwd = 0.0
    for e in events:
        for k in e.kernels:
            if "bn_sums_grad" in k.name:
                bwd += k.duration
            elif "bn_sums" in k.name:
                fwd += k.duration
    return fwd, bwd


def measure(clips: int, steps: int, clip_len: int = 16, size: int = 112,
            device: str = "cuda") -> dict:
    import torch
    from torch.profiler import ProfilerActivity, profile

    from zeroshotvideoclassification_tpu_torch.config import Config
    from zeroshotvideoclassification_tpu_torch.models import get_network
    from zeroshotvideoclassification_tpu_torch.ops.bn_stats import (
        bn_sums_cuda,
        bn_sums_grad_cuda,
    )
    from zeroshotvideoclassification_tpu_torch.train import (
        make_optimizer,
        make_train_step,
    )
    from zeroshotvideoclassification_tpu_torch.utils import profiler

    dev = torch.device(device)
    cuda = dev.type == "cuda"
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.benchmark = True
    dtype = torch.bfloat16 if cuda else torch.float32
    cfg = Config(network="r2plus1d_18", head="mlp", clip_len=clip_len,
                 size=size, n_clips=1,
                 compute_dtype="bfloat16" if cuda else "float32")
    gen = torch.Generator().manual_seed(0)
    model = get_network(cfg).to(dev).to(
        memory_format=torch.channels_last_3d)
    optimizer = make_optimizer(model.parameters(), 1e-4)
    step = make_train_step(model, optimizer, compute_dtype=dtype)
    x = torch.randn(clips, 1, clip_len, size, size, 3,
                    generator=gen).to(dev, dtype)
    z = torch.randn(clips, 300, generator=gen).to(dev)
    label = torch.zeros(clips, dtype=torch.int32, device=dev)
    weight = torch.ones(clips, device=dev)
    embed = torch.randn(8, 300, generator=gen).to(dev)
    for _ in range(WARMUP):
        step(x, z, label, weight, embed)
    if cuda:
        torch.cuda.synchronize(dev)
    profiler.reset()
    activities = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if cuda else [])
    before = (bn_sums_cuda.launches, bn_sums_grad_cuda.launches)
    with profile(activities=activities) as prof:
        for _ in range(steps):
            step(x, z, label, weight, embed)
        if cuda:
            torch.cuda.synchronize(dev)
    launches = [(b - a) / steps for a, b in zip(
        before, (bn_sums_cuda.launches, bn_sums_grad_cuda.launches))]
    reg = profiler.registry()
    brackets = {}
    for name in ("bn.stats", "bn.stats.backward"):
        ms = [i.device_ms for i in reg.instances(name)]
        brackets[name] = (sum(ms) / steps if ms and None not in ms
                          else None)
    events = prof.events()
    fwd_us, bwd_us, ops, nodes = link(events)
    sums_fwd_us, sums_bwd_us = sums_kernel_us(events)
    out = {"device": (torch.cuda.get_device_name(dev) if cuda else "cpu"),
           "clips": clips, "steps": steps,
           "bracket_fwd_ms": brackets["bn.stats"],
           "bracket_bwd_ms": brackets["bn.stats.backward"],
           "kernels_fwd_ms": fwd_us / 1e3 / steps,
           "kernels_bwd_ms": bwd_us / 1e3 / steps,
           "forward_ops": len({(o.thread, o.sequence_nr)
                               for o in ops}) // steps,
           "backward_nodes": len(nodes) // steps,
           "sums_ops": sum(o.name == "_BNSums" for o in ops) // steps,
           "sums_nodes": sum(n.name.endswith(": _BNSumsBackward")
                             for n in nodes) // steps,
           "sums_kernels_fwd_ms": sums_fwd_us / 1e3 / steps,
           "sums_kernels_bwd_ms": sums_bwd_us / 1e3 / steps,
           "sums_launches": launches[0], "sums_grad_launches": launches[1],
           "instances": {k: len(reg.instances(k)) for k in brackets}}
    for part in ("fwd", "bwd"):
        b, k = out[f"bracket_{part}_ms"], out[f"kernels_{part}_ms"]
        out[f"ratio_{part}"] = b / k if b is not None and k > 0 else None
    if None not in (out["bracket_fwd_ms"], out["bracket_bwd_ms"]):
        k = out["kernels_fwd_ms"] + out["kernels_bwd_ms"]
        out["ratio"] = ((out["bracket_fwd_ms"] + out["bracket_bwd_ms"]) / k
                        if k > 0 else None)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--clips", type=int, default=64)
    p.add_argument("--steps", type=int, default=3)
    p.add_argument("--clip_len", type=int, default=16)
    p.add_argument("--size", type=int, default=112)
    p.add_argument("--device", default="cuda")
    p.add_argument("--json", default="")
    args = p.parse_args(argv)
    if args.device.startswith("cuda"):
        from benchmark.harness import card

        print(f"card: {card()}", flush=True)
    out = measure(args.clips, args.steps, args.clip_len, args.size,
                  args.device)
    line = json.dumps(out)
    print(line, flush=True)
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)),
                    exist_ok=True)
        with open(args.json, "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
