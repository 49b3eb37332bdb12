#!/usr/bin/env python3
"""chip_smoke.py's phase 19 alone: --steps_per_call as CUDA graphs of the
train step.

    python3 tools/graph_phase.py [--json PATH]
                                 [--nccl_only | --tp_grid | --locate]

Builds the kernels, then runs phase 19 as chip_smoke.py does: float32 runs
of the trainer at --steps_per_call 4 against 1 (two epochs of 8 steps, and
one epoch of 6 with a tail of 2), the bf16 step eager and as a replay / 4
with peak memory and the capture's time, K2's kernel nodes in one replay,
a group of NaN batches, --debug_nans grouped and ungrouped, resnet18's
dropout across replays, one --remat full group, and NCCL groups of one
process (and of two where the host shows two GPUs) with the all-reduces
captured; then the trainer's other options under graphs (--remat convs,
--fixconvs, C3D, --clip_pool embedding, the linear head), each two groups
of 2 float32 steps against 4 single steps (chip_smoke.graph_options, which
chip_smoke.py itself does not run). Each check fails the run as it does in
chip_smoke.py. --nccl_only runs the NCCL groups alone (on a host with
several GPUs: the captured all-reduces across two cards) and times each
process's bf16 step of 8 clips eagerly and as a replay / 4. --tp_grid runs
four processes as a 2 x 2 grid at --tp 2 under NCCL, one GPU each (a host
with four GPUs): two groups of 4 float32 steps of 8 clips a data shard
with the data and model groups' all-reduces captured, against single
steps in the grid, and each process's bf16 step eagerly and as a replay /
4. --locate runs only locate below (where float32 steps under the graphs
part from single steps), with cuDNN free to pick any algorithm and then
restricted to deterministic ones. Needs an NVIDIA GPU; prints the card's
name and power limit first.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOCATE_GROUPS = 3  # groups of GRAPH_K float32 steps in each run of locate
RUN_KINDS = ("eager", "eager again", "one-step graph", "four-step graph")


def _record_outputs(model, acts):
    """Forward hooks that copy the output of the backbone's stem, of each
    of its layers and of the head into `acts` (a buffer a module, made at
    its first call unless `acts` holds one), so that a graph's replay
    refills them. -> the hooks' handles."""
    import torch

    handles = []
    for name, mod in [*model.model.named_children(),
                      ("head", model.output2emb_proj)]:
        def hook(_mod, _args, out, name=name):
            if name not in acts:
                acts[name] = torch.empty_like(out)
            acts[name].copy_(out.detach())

        handles.append(mod.register_forward_hook(hook))
    return handles


def _snapshot(exp, acts, grads):
    """The tensors a step makes, in the order it makes them: the recorded
    outputs (forward order), the gradients (backward order; only where
    they are this step's), the parameters, Adam's moments and BN's running
    statistics. -> {name: a copy on the card}."""
    out = {f"out/{k}": v.clone() for k, v in acts.items()}
    params = list(exp.model.named_parameters())
    if grads:
        out.update((f"grad/{n}", p.grad.clone()) for n, p in reversed(params)
                   if p.grad is not None)
    out.update((f"param/{n}", p.detach().clone()) for n, p in params)
    for slot in ("exp_avg", "exp_avg_sq"):
        out.update((f"{slot}/{n}", exp.optimizer.state[p][slot].clone())
                   for n, p in params)
    out.update((f"bn/{n}", b.clone()) for n, b in exp.model.named_buffers()
               if n.endswith(("running_mean", "running_var")))
    return out


def _parted(ref, got):
    """[(name, max |difference|)] of the tensors of `got` that are not
    bit-equal to `ref`'s, in `got`'s order."""
    import torch

    return [(k, float((v.double() - ref[k].double()).abs().max()))
            for k, v in got.items() if not torch.equal(v, ref[k])]


def _run(cs, kind, args, dev, batches, acts):
    """One run of locate: `kind` (RUN_KINDS) over `batches`. -> (losses,
    {step index: _snapshot after it}), the experiment released."""
    import torch

    from torch_helpers import seed_adam
    from zeroshotvideoclassification_tpu_torch.train import (
        make_scan_train_step,
    )

    exp, _, ce = cs.experiment(args, dev)
    seed_adam(exp.optimizer, exp.model, seed=3, count=1000)
    handles = _record_outputs(exp.model, acts)
    losses, snaps = [], {}
    if kind.startswith("eager"):
        for i, b in enumerate(batches):
            losses.append(float(exp.train_step(*b, ce)["loss"]))
            snaps[i] = _snapshot(exp, acts, grads=True)
    else:
        k = cs.GRAPH_K
        per = 1 if kind == "one-step graph" else k
        scan = make_scan_train_step(exp.model, exp.optimizer, torch.float32,
                                    k)
        i = 0
        while i < len(batches):
            # the first call: GRAPH_K eager steps, then the two captures
            size = k if i == 0 else per
            for j in range(size):
                scan.stage(j, *batches[i + j])
            losses.extend(scan.run(size, ce)["loss"].tolist())
            i += size
            # a capture records and does not run: after the first group,
            # and after a K-step replay, the parameters' .grad are not
            # that step's
            snaps[i - 1] = _snapshot(exp, acts, grads=i > k and size == 1)
        del scan
    for h in handles:
        h.remove()
    exp.log.close()
    del exp
    cs.release()
    return losses, snaps


def locate(cs, tmp, dev, deterministic):
    """Where float32 steps under CUDA graphs part from single steps: the
    same LOCATE_GROUPS x GRAPH_K batches of TRAIN_BS clips (r2plus1d_18,
    phase 19's seeded Adam state and lr) from one initial state, taken
    four ways in this process (RUN_KINDS): eager steps (the reference),
    eager steps again, the scan step at GRAPH_K replaying its one-step
    graph after its eager first group, and the scan step replaying its
    GRAPH_K-step graph. After each step (of a graph run: after each
    replay; its first group shows only its losses until its last step)
    every tensor of _snapshot is held to the reference's bit for bit. With
    `deterministic`, cuDNN may run only deterministic algorithms
    (torch.backends.cudnn.deterministic). -> {run: the first step that
    parts (1-based, None: none), the first tensor apart there with its
    difference, the tensors apart there by kind, the largest relative
    loss difference and the largest parameter difference at the end}."""
    import collections

    import torch

    from zeroshotvideoclassification_tpu_torch.data.pipeline import (
        HostPipeline,
    )

    n = LOCATE_GROUPS * cs.GRAPH_K
    torch.backends.cudnn.deterministic = deterministic
    args = cs.cli_argv(tmp, dev, "float32", cs.TRAIN_BS, cs.TRAIN_BS * n,
                       "--lr", cs.GRAPH_LR)
    exp, _, _ = cs.experiment(args, dev)
    pipe = HostPipeline(exp.datasets["training"][0], exp.config,
                        cs.TRAIN_BS, seed=exp.config.seed)
    batches = []
    for host, _ in zip(pipe, range(n)):
        b = cs.to_card(exp, host)
        batches.append([b[key] for key in ("x", "z", "label", "weight")])
    exp.log.close()
    del exp
    acts = {}
    ref_losses, ref = _run(cs, RUN_KINDS[0], args, dev, batches, acts)
    out = {}
    for kind in RUN_KINDS[1:]:
        # the outputs' buffers are the reference's, made before any pool
        losses, snaps = _run(cs, kind, args, dev, batches, acts)
        parted = {i: _parted(ref[i], s) for i, s in snaps.items()}
        del snaps
        at_loss = next((i for i, (a, b) in enumerate(zip(losses, ref_losses))
                        if a != b), None)
        at_state = next((i for i in sorted(parted) if parted[i]), None)
        first = min((i for i in (at_loss, at_state) if i is not None),
                    default=None)
        where = parted.get(first) or []
        if first is not None and not where:
            where = [("loss", abs(losses[first] - ref_losses[first]))]
        last = parted[max(parted)]
        out[kind] = {
            "first_step": None if first is None else first + 1,
            "first_tensor": where[0] if where else None,
            "apart_by_kind": dict(collections.Counter(
                name.split("/")[0] for name, _ in where)),
            "loss_rel": max(abs(a - b) / abs(b)
                            for a, b in zip(losses, ref_losses)),
            "param_max_abs": max((d for name, d in last
                                  if name.startswith("param/")),
                                 default=0.0),
            "losses": losses}
        cs.say(f"[locate] cudnn.deterministic={deterministic}: {kind} "
               f"against eager steps over {n} float32 steps of "
               f"{cs.TRAIN_BS} clips: first apart at step "
               f"{out[kind]['first_step']}, first tensor "
               f"{out[kind]['first_tensor']}, apart there by kind "
               f"{out[kind]['apart_by_kind']}; losses rel "
               f"{out[kind]['loss_rel']:.3g}, parameters at the end "
               f"{out[kind]['param_max_abs']:.3g} apart")
    del ref
    cs.release()
    torch.backends.cudnn.deterministic = False
    return {"reference_losses": ref_losses, **out}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--json", default=None,
                   help="also write every measurement to this file")
    p.add_argument("--nccl_only", action="store_true",
                   help="run only the NCCL groups of phase 19")
    p.add_argument("--tp_grid", action="store_true",
                   help="run only the 2 x 2 grid at --tp 2 (four GPUs)")
    p.add_argument("--locate", action="store_true",
                   help="run only locate: where float32 steps under the "
                        "graphs part from single steps")
    args = p.parse_args(argv)
    sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]
    import torch

    if not torch.cuda.is_available():
        print("graph_phase: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    import chip_smoke as cs

    smi = cs.phase_env()
    cs.phase_build()
    dev = torch.device("cuda:0")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.benchmark = True
    with tempfile.TemporaryDirectory(prefix="graph_phase_") as tmp:
        if args.tp_grid:
            cs.RECORD["tp_grid"] = cs.graph_tp_grid(tmp)
        elif args.locate:
            cs.RECORD["locate"] = {
                str(det): locate(cs, tmp, dev, det) for det in (False, True)}
        elif args.nccl_only:
            cs.RECORD["nccl"] = cs.graph_nccl(tmp, timed=True)
        else:
            cs.phase_graphs(tmp, dev, smi)
            cs.graph_options(tmp, dev)
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)),
                    exist_ok=True)
        with open(args.json, "w") as f:
            json.dump(cs.RECORD, f, indent=1, default=str)
    cs.say(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
