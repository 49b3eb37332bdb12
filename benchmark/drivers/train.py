"""Train cells: the port's train step as cli/main.Experiment builds it
(get_network, make_optimizer, make_train_step; TF32 off and cuDNN's
autotuning on), fed by data.pipeline.device_batch with a pool of host
batches made from the seed (benchmark/yardstick/traffic.py), so decode
stays out of the cell.

Set-up builds the step once, loads the seeded weights into it and drives
it through the first `checked_steps` steps (cuDNN times its algorithms
there), which the plain reference follows once the window has closed. The
window then runs the same object on the pool, cycled, for `--seconds`.

`run` is one process on one card; `process` is the body of every process
of the data-parallel cell too (drivers/train_dp.py), where the loop's end
is agreed over a gloo group each step so that every process takes the same
number of steps.
"""

from __future__ import annotations

import gc
import time
from typing import Optional

import torch

from benchmark.reference.models import Net
from benchmark.reference.train import BETAS, follow
from benchmark.yardstick import checks, traffic, weights
from benchmark.yardstick.tracing import Recorder


class Record:
    """What the per-layer readers read (benchmark/metrics/*.py)."""

    def __init__(self, **kw):
        self.__dict__.update(kw)


def build_program(cfg: dict, params: dict, lr: float, device):
    """The program's model, guarded Adam and step, holding `params`."""
    from zeroshotvideoclassification_tpu_torch.config import Config, \
        torch_dtype
    from zeroshotvideoclassification_tpu_torch.models import get_network
    from zeroshotvideoclassification_tpu_torch.train import (
        make_optimizer,
        make_train_step,
        set_lr,
    )

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.benchmark = True
    config = Config(network=cfg["network"], head=cfg["head"],
                    clip_len=cfg["clip_len"], size=cfg["size"],
                    n_clips=cfg["n_clips"],
                    compute_dtype=cfg["compute_dtype"], lr=lr)
    with torch.device("meta"):
        model = get_network(config)
    model = model.to_empty(device=device)
    load_params(model, params)
    model = model.to(memory_format=torch.channels_last_3d)
    optimizer = make_optimizer(model.parameters(), lr)
    set_lr(optimizer, lr)
    step = make_train_step(model, optimizer,
                           compute_dtype=torch_dtype(cfg["compute_dtype"]))
    return config, model, optimizer, step


@torch.no_grad()
def load_params(model, params: dict) -> None:
    """Copy the benchmark's weights into the program's model, key for key;
    BN running statistics as a fresh model's (mean 0, variance 1) unless
    `params` has them."""
    have = dict(model.named_parameters())
    if set(have) != {k for k in params if not k.endswith(
            ("running_mean", "running_var"))}:
        raise ValueError(f"parameters differ: {sorted(set(have) ^ set(params))}")
    for k, p in have.items():
        p.copy_(params[k])
    for k, b in model.named_buffers():
        if k in params:
            b.copy_(params[k])
        elif k.endswith("running_mean") or k.endswith("num_batches_tracked"):
            b.zero_()
        elif k.endswith("running_var"):
            b.fill_(1.0)
        else:
            raise ValueError(f"unknown buffer {k}")


def host_batch(hb: dict):
    from zeroshotvideoclassification_tpu_torch.data.pipeline import HostBatch

    return HostBatch(canvas=hb["canvas"], y0=hb["y0"], y1=hb["y1"],
                     wy=hb["wy"], x0=hb["x0"], x1=hb["x1"], wx=hb["wx"],
                     z=hb["z"], label=hb["label"], weight=hb["weight"])


def process(ctx, rank: int = 0, world: int = 1,
            stop_group=None) -> Optional[dict]:
    """One process of a train cell. -> the cell's outcome on rank 0 (None
    elsewhere)."""
    from zeroshotvideoclassification_tpu_torch.config import transform_dtype
    from zeroshotvideoclassification_tpu_torch.data.pipeline import (
        device_batch,
    )

    cfg, tr = ctx.config, ctx.cell["traffic_params"]
    device = torch.device(ctx.device)
    synced = world > 1
    lead = rank == 0
    rec = Recorder(ctx.trace and lead)
    net = Net(cfg["network"], cfg["clip_len"], cfg["size"], ctx.root)
    params = weights.make(net, ctx.seed, device)
    config, model, optimizer, step = build_program(cfg, params, tr["lr"],
                                                    device)
    pool = traffic.train_pool(cfg, tr, ctx.seed, device, rank)
    hosts = [host_batch(hb) for hb in pool]
    embed = torch.from_numpy(traffic.class_embeddings(
        tr["classes"], ctx.seed)).to(device)
    rate = cfg.get("dropout", 0.0)
    dropout_seed = weights.subseed(ctx.seed, f"dropout.{rank}")
    rng = torch.Generator(device).manual_seed(dropout_seed)
    out_dtype = transform_dtype(config)
    names = [k for k, _ in model.named_parameters()]

    def one_step(i):
        with rec.span("feed"):
            b = device_batch(hosts[i % len(hosts)], cfg["n_clips"],
                             cfg["clip_len"], out_dtype, device)
        with rec.span("step"):
            return step(b["x"], b["z"], b["label"], b["weight"], embed, rng)

    # set-up: the checked steps, through the window's own call and feed
    n_checked = tr["checked_steps"]
    losses, grad = [], None
    for i in range(n_checked):
        losses.append(one_step(i)["loss"])
        if i == 0:  # Adam's first moment after one step is (1 - b1) g
            grad = {k: _first_grad_norm(optimizer, p)
                    for k, p in zip(names, model.parameters())}
    delta = {k: float(torch.linalg.vector_norm(p.detach() - params[k]))
             for k, p in zip(names, model.parameters())}
    prog = {"loss": [float(v) for v in losses], "grad": grad, "delta": delta}
    torch.cuda.synchronize(device) if device.type == "cuda" else None
    setup_peak = _peak(device)
    rec.seconds.clear()

    # the window
    flags = []
    _reset_peak(device)
    t_window = time.time()

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    with rec.window(sync):
        t0, i = time.perf_counter(), n_checked
        while True:
            if stop_group is None:
                done = time.perf_counter() - t0 >= ctx.seconds
            else:
                flag = torch.tensor([int(lead and time.perf_counter() - t0
                                         >= ctx.seconds)])
                torch.distributed.all_reduce(flag, group=stop_group)
                done = bool(flag.item())
            if done:
                break
            flags.append(one_step(i)["finite"])
            i += 1
    window_s = rec.window_s
    t_ref = time.time()
    steps = len(flags)
    failed = int((~torch.stack(flags)).sum()) if flags else 0
    window_peak = _peak(device)
    peaks = torch.tensor([float(window_peak), float(max(setup_peak,
                                                         window_peak))],
                         device=device)
    if synced:
        torch.distributed.all_reduce(peaks, op=torch.distributed.ReduceOp.MAX)

    # the program's state goes before the reference runs
    del model, optimizer, step, hosts, flags
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    ref = follow(net, params, pool[:n_checked], cfg["n_clips"],
                 cfg["clip_len"], tr["lr"], device, synced=synced,
                 dropout=(rate, torch.Generator(device).manual_seed(
                     dropout_seed)) if rate else None)
    if not lead:
        return None
    notes = [f"set-up {t_window - ctx.t_start:.1f} s, window "
             f"{window_s:.1f} s ({steps} steps), reference "
             f"{time.time() - t_ref:.1f} s"]
    numbers = checks.train_numbers(prog, ref)
    clips = tr["batch"] * cfg["n_clips"] * world
    record = Record(root=ctx.root, cfg=cfg, cell=ctx.cell, chips=world,
                    steps=steps, clips_per_step=clips,
                    local_clips=clips // world,
                    window_s=window_s, seconds=dict(rec.seconds),
                    trace=rec.trace, counters={})
    return {"e2e": {"train_clips_per_s": steps * clips / window_s,
                    "peak_mem_gib": float(peaks[0]) / 2 ** 30,
                    "setup_s": t_window - ctx.t_start},
            "attempted": steps, "failed": failed,
            "memory_peak_bytes": int(peaks[1]), "numbers": numbers,
            "record": record, "trace": rec.trace, "notes": notes,
            "readings": {"program": prog, "reference": ref}}


def _first_grad_norm(optimizer, p) -> float:
    """The norm of the gradient the optimizer got at its first step, from
    its first moment (0 where it holds none)."""
    m = optimizer.state.get(p, {}).get("exp_avg")
    if m is None:
        return 0.0
    return float(torch.linalg.vector_norm(m)) / (1 - BETAS[0])


def _peak(device) -> int:
    return (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)


def _reset_peak(device) -> None:
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)


def run(ctx) -> dict:
    return process(ctx)
