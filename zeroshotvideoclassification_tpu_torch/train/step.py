"""The training and inference steps.

Counterpart of zeroshotvideoclassification_tpu/train/step.py: one call per
step — train-mode forward (bf16 compute with float32 master weights, BN batch
statistics), masked MSE, backward (K2's backward kernel in every epilogue),
the guarded Adam update, and the train accuracy against the TRAIN class
embeddings on the device. Fresh gradients every step. Nothing in the step
synchronises with the host: loss, accuracy and the guard's `finite` flag
come back as device scalars.

make_scan_train_step is the counterpart of the JAX package's scan-fused
multi-step dispatch (step.py:94, --steps_per_call K): on a GPU, K steps as
one replay of a CUDA graph, captured once from these same steps (see its
docstring for what a capture holds fixed); on the CPU the same K steps one
after the other.

Under a process group (parallel/multihost.py) each process steps on its
shard of the global batch and the step computes what the JAX package's
computes on the whole batch: BN statistics are global (models/layers.py),
the loss divides by the GLOBAL weight sum, so each process's loss is its
share of the global loss, and the gradients are SUMMED over the processes
(not averaged, as DDP averages them: with shares of one loss the sum is the
gradient of the global loss, also where the shards' weight sums differ).
Every process then holds the same gradients, and the guarded Adam takes the
same decision and the same update everywhere. Under --tp these sums run
over the data group (one process a data shard): the processes of a model
group see the same rows and hold the same loss, their backbone gradients
are made whole by the head's copy_to_model (and averaged over the model
group, sum_gradients), and each keeps its own shard of the head's
gradients; the guarded Adam agrees its finite flag over the model group.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, Optional

import torch
from torch import nn

from zeroshotvideoclassification_tpu_torch.ops.cdist import nearest_class
from zeroshotvideoclassification_tpu_torch.parallel.multihost import (
    all_reduce_,
    check_capturable,
    data_group,
    grid,
    group_active,
)


@dataclasses.dataclass
class TrainState:
    """The model (parameters and BN statistics), its optimizer (moments and
    count) and the number of steps taken, skipped ones included."""

    model: nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0


def masked_mse(emb: torch.Tensor, z: torch.Tensor,
               weight: torch.Tensor) -> torch.Tensor:
    """MSELoss(mean) over valid samples only (reference/main.py:130,179 +
    mask); an all-zero weight gives loss 0 and zero gradients. The
    denominator is the weight sum of the global batch (summed over the
    data group), so under a group this is this process's share of the
    global loss."""
    per = torch.mean(torch.square(emb - z.float()), dim=-1)
    denom = torch.clamp_min(all_reduce_(torch.sum(weight.detach()),
                                        data_group()), 1.0)
    return torch.sum(per * weight) / denom


def sum_gradients(params) -> None:
    """Sum the gradients of `params` (those that have one) over the data
    group, in place, as one all-reduce of a flat buffer; nothing without a
    group. Every process must have gradients for the same parameters (of
    the same shapes across its data group).

    Under --tp the processes of a model group hold replicas of every
    parameter but the head's shards (marked `model_parallel`), and each
    computes their gradients on its own: on a GPU each process's cuDNN
    picks its algorithms by timing and may sum in another order, so the
    replicas' gradients can differ in their last bits, and the replicas
    would drift apart. Their gradients are therefore summed over every
    process and divided by tp (the model group's mean, exact where the
    members agree; tp divides 512, a power of two, for the mlp head), so
    that every replica takes the same update; the shards' gradients are
    summed over the data group."""
    with_grad = [p for p in params if p.grad is not None]
    if not with_grad or not group_active():
        return
    g = grid()
    shards = [p.grad for p in with_grad if getattr(p, "model_parallel",
                                                   False)]
    replicas = [p.grad for p in with_grad if not getattr(
        p, "model_parallel", False)]
    # (gradients, their group, the divisor): every process for the
    # replicas of a model group, else the data group
    parts = ((replicas, None, g.tp) if g.tp > 1 else
             (replicas, g.data_group, 1), (shards, g.data_group, 1))
    for grads, group, tp in parts:
        if not grads:
            continue
        flat = torch._utils._flatten_dense_tensors(grads)
        if tp > 1:
            flat.mul_(1.0 / tp)
        all_reduce_(flat, group)
        for t, total in zip(grads, torch._utils._unflatten_dense_tensors(
                flat, grads)):
            t.copy_(total)


def make_train_step(model: nn.Module, optimizer: torch.optim.Optimizer,
                    compute_dtype: torch.dtype = torch.bfloat16) -> Callable:
    """Returns step(x, z, labels, weight, class_embed, rng=None) -> metrics,
    which updates `model` and `optimizer` (the guarded Adam) in place.
    Shapes: x [B, nc, T, H, W, 3] (normalized floats), z [B, 300], labels
    [B] int32, weight [B] (1 valid / 0 broken-or-pad), class_embed [C, 300].
    metrics = {"loss", "train_accuracy", "finite"}, 0-dim tensors on the
    model's device: the loss and accuracy of the global batch under a
    process group, and the guard's flag (False: the step was skipped). `rng`
    (a torch.Generator on the model's device) draws the dropout masks of the
    linear and C3D heads; without one they drop nothing.

    The convs run in `compute_dtype` on casts of their float32 weights, so
    gradients and the optimizer's moments are float32. Under --fixconvs
    the backbone's parameters get no gradient, and the optimizer leaves
    them (and their moments) as they are. `step.body` is the same step
    without the host's count (`step.state.step`), as a graph captures it."""
    model.set_compute_dtype(compute_dtype, masters=True)
    state = TrainState(model, optimizer)

    def body(x, z, labels, weight, class_embed,
             rng: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        model.train()
        optimizer.zero_grad(set_to_none=True)
        with torch.enable_grad():  # whatever mode the caller is in
            emb = model(x, generator=rng)
            loss = masked_mse(emb, z, weight)
        loss.backward()
        sum_gradients(model.parameters())
        optimizer.step()
        with torch.no_grad():
            pred = nearest_class(emb, class_embed)
            correct = (pred == labels).float() * weight
            # the global loss and accuracy: one all-reduce of the shares
            totals = all_reduce_(torch.stack([
                loss.detach(), torch.sum(correct), torch.sum(weight)]),
                data_group())
            acc = totals[1] / torch.clamp_min(totals[2], 1.0) * 100.0
        return {"loss": totals[0], "train_accuracy": acc,
                "finite": optimizer.last_finite.clone()}

    def step(x, z, labels, weight, class_embed,
             rng: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        metrics = body(x, z, labels, weight, class_embed, rng)
        state.step += 1
        return metrics

    step.state = state
    step.body = body
    return step


_INPUTS = ("x", "z", "label", "weight")
_METRICS = (("loss", torch.float32), ("train_accuracy", torch.float32),
            ("finite", torch.bool))


def make_scan_train_step(model: nn.Module, optimizer: torch.optim.Optimizer,
                         compute_dtype: torch.dtype = torch.bfloat16,
                         steps: int = 2) -> Callable:
    """K = `steps` train steps a dispatch: the counterpart of the JAX
    package's make_scan_train_step (step.py:94-133).

    Returns step(xs, zs, labels, weights, class_embed, rng=None) ->
    metrics: xs [n, B, ...] and so on, n <= K batches of make_train_step's
    shapes; metrics = {"loss", "train_accuracy", "finite"} of [n] tensors,
    one entry a step. `step.state.step` advances by n. A call is
    `step.stage(k, x, z, label, weight)` for each batch (a copy into input
    slot k; the trainer stages each batch as it arrives) and then
    `step.run(n, class_embed, rng)`; `step.single` is the one-step function
    (make_train_step) over the same state.

    On a GPU the steps run as CUDA graphs. The first call of K batches runs
    them eagerly (cuDNN's autotuning, the kernels' plans and library, the
    optimizer's moments and a process group's communicator all come up on a
    first call; it allocates from the graphs' memory pool, on their
    stream, so that the captures find there every block a step needs),
    then captures two graphs in that pool: K steps, reading slots 0 ..
    K-1, and one step, reading slot 0. Every later call
    of K batches is one replay of the first; a call of n < K (an epoch's
    tail, as the JAX package drains a partial group through its single
    step) replays the second n times. A failed capture or replay raises:
    nothing falls back to eager steps; a capture that runs out of device
    memory raises torch.OutOfMemoryError. A capture holds fixed:

      * the input slots, the class-embedding slot (copied into at every
        call) and the metrics, allocated outside the pool; the metrics are
        cloned after a replay, which the next one overwrites;
      * every parameter, buffer and optimizer tensor, by address: a call
        raises once any was replaced (restore in place, as
        train/checkpoint.load_checkpoint does);
      * the generator `rng`, registered with both graphs: each replay draws
        new masks, and manual_seed reseeds it between epochs; a call with
        another generator raises;
      * the learning rate as the optimizer's device tensors, refilled from
        the groups' `lr` before every replay (set_lr).

    Launch counters in the kernels' wrappers count while a graph is
    captured and not when it replays. The graphs keep their node lists
    (keep_graph), so `step.graphs[K][0].debug_dump(path)` writes one out
    as DOT; `step.captured["seconds"]` is the host time the capture and
    the instantiation took.

    On the CPU, which has no graphs, every call runs its steps eagerly, one
    after the other, from the same slots. A CUDA run under a gloo group
    raises here (parallel.multihost.check_capturable)."""
    if steps < 2:
        raise ValueError(f"steps {steps}: a scan of one step is the single "
                         f"step (make_train_step)")
    single = make_train_step(model, optimizer, compute_dtype)
    device = optimizer.count.device
    capture = device.type == "cuda"
    if capture:
        check_capturable(device)
    # the graphs' memory pool and the stream they are captured on (the
    # first group runs there too: first_group)
    pool = torch.cuda.MemPool() if capture else None
    stream = torch.cuda.Stream(device) if capture else None
    slots: Dict[str, torch.Tensor] = {}
    graphs: Dict[int, tuple] = {}
    captured = {"seconds": None}

    def slot(name, t, lead=()):
        """The slot `name` shaped (*lead, *t.shape); a new one only before
        a capture."""
        want = (*lead, *t.shape)
        have = slots.get(name)
        if have is None or tuple(have.shape) != want or have.dtype != t.dtype:
            if graphs:
                raise ValueError(
                    f"{name}: {t.dtype} {tuple(t.shape)} after a capture "
                    f"at {have.dtype} {tuple(have.shape)[len(lead):]}")
            have = slots[name] = torch.empty(want, dtype=t.dtype,
                                             device=device)
        return have

    def stage(k: int, x, z, label, weight) -> None:
        if not 0 <= k < steps:
            raise ValueError(f"slot {k} of {steps}")
        for name, t in zip(_INPUTS, (x, z, label, weight)):
            slot(name, t, (steps,))[k].copy_(t)

    def inputs(k):
        return [slots[name][k] for name in _INPUTS]

    def tensors():
        """Every tensor a graph reads or writes in place, by address."""
        st = [v for s in optimizer.state.values() for v in s.values()
              if torch.is_tensor(v)]
        return [t.data_ptr() for t in (
            *model.parameters(), *model.buffers(), *st,
            *optimizer.lr_tensors, optimizer.count,
            optimizer.notfinite_count, optimizer.total_notfinite,
            optimizer.last_finite)]

    def first_group(n, ce, rng):
        """The first group's n steps, eagerly, on the captures' stream,
        every allocation made there (by the backward's thread too) taken
        from the graphs' pool: the pool then holds the blocks a step asks
        for (cuDNN's plans' workspaces among them), and the captures that
        follow take them from it, as the eager steps took them. A cached
        cuDNN plan whose workspace does not fit makes cuDNN search again,
        which an eager step may do; inside a capture that search
        invalidates the capture (PERF.md, F4; tools/f4_probe.py). The
        default pool's cached blocks are released first (empty_cache): while
        the pool takes allocations, the allocator frees none of them to
        make room. -> the steps' metrics."""
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()
        current = torch.cuda.current_stream(device)
        stream.wait_stream(current)
        with torch.cuda.stream(stream):
            torch._C._cuda_beginAllocateCurrentStreamToPool(device.index,
                                                           pool.id)
            try:
                ms = [single(*inputs(k), ce, rng) for k in range(n)]
            finally:
                torch._C._cuda_endAllocateToPool(device.index, pool.id)
                torch._C._cuda_releasePool(device.index, pool.id)
        current.wait_stream(stream)
        return ms

    def capture_graphs(ce, rng):
        ooms = torch.cuda.memory_stats(device).get("num_ooms", 0)
        t0 = time.perf_counter()
        try:
            for n in (steps, 1):
                g = torch.cuda.CUDAGraph(keep_graph=True)
                if rng is not None:
                    g.register_generator_state(rng)
                outs = {k: torch.empty(n, dtype=dt, device=device)
                        for k, dt in _METRICS}
                with torch.cuda.graph(g, pool=pool.id, stream=stream):
                    for k in range(n):
                        m = single.body(*inputs(k), ce, rng)
                        for key, out in outs.items():
                            out[k].copy_(m[key])
                    del m
                g.instantiate()
                graphs[n] = (g, outs)
        except BaseException as e:
            graphs.clear()  # no half-captured pair is ever replayed
            if (not isinstance(e, torch.OutOfMemoryError)
                    and torch.cuda.memory_stats(device).get("num_ooms", 0)
                    > ooms):
                # an allocation inside the capture failed and a library
                # caught it (cuDNN then searches inside the capture): the
                # card lacks the memory, and that is the error
                raise torch.OutOfMemoryError(
                    f"the capture of the train step's CUDA graphs ran out "
                    f"of device memory ({type(e).__name__} after an "
                    f"allocation failed inside it: {e})") from e
            raise
        torch.cuda.synchronize(device)
        captured.update(rng=rng, tensors=tensors(),
                        seconds=time.perf_counter() - t0)

    def replay(n):
        g, outs = graphs[n]
        g.replay()
        single.state.step += n
        return {k: v.clone() for k, v in outs.items()}

    def run(n: int, class_embed: torch.Tensor,
            rng: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        if not 0 < n <= steps:
            raise ValueError(f"{n} batches for a scan of {steps}")
        ce = slot("class_embed", class_embed)
        ce.copy_(class_embed)
        if not graphs:
            if capture and n == steps:  # the group before the capture
                ms = first_group(n, ce, rng)
                capture_graphs(ce, rng)
            else:
                ms = [single(*inputs(k), ce, rng) for k in range(n)]
            return {key: torch.stack([m[key] for m in ms]) for key, _ in
                    _METRICS}
        if rng is not captured["rng"]:
            raise ValueError("the graphs were captured with another "
                             "generator: reseed that one (manual_seed)")
        if tensors() != captured["tensors"]:
            raise RuntimeError("a parameter, buffer or optimizer tensor was "
                               "replaced after the capture; restore state in "
                               "place")
        model.train()
        optimizer.sync_lr()
        if n == steps:
            return replay(steps)
        parts = []
        for k in range(n):
            if k:
                for name in _INPUTS:
                    slots[name][0].copy_(slots[name][k])
            parts.append(replay(1))
        return {key: torch.cat([p[key] for p in parts]) for key, _ in
                _METRICS}

    def step(xs, zs, labels, weights, class_embed,
             rng: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        for k in range(xs.shape[0]):
            stage(k, xs[k], zs[k], labels[k], weights[k])
        return run(xs.shape[0], class_embed, rng)

    step.stage, step.run, step.single = stage, run, single
    step.state, step.steps, step.graphs = single.state, steps, graphs
    step.captured = captured
    return step


def raise_if_not_finite(metrics: Dict[str, torch.Tensor],
                        first_step: int) -> None:
    """--debug_nans after a dispatch of steps first_step, first_step + 1,
    ...: read its `finite` flags and losses on the host and raise
    FloatingPointError naming the first step that is not finite (the guard
    skipped its update; a group's later steps were taken)."""
    ok = (metrics["finite"] & torch.isfinite(metrics["loss"])).reshape(-1)
    ok = ok.cpu()
    if not bool(ok.all()):
        k = int((~ok).nonzero()[0])
        raise FloatingPointError(
            f"--debug_nans: step {first_step + k} is not finite (loss "
            f"{float(metrics['loss'].reshape(-1)[k])}, step {k + 1} of its "
            f"dispatch of {ok.numel()})")


def eval_step(model: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """x [B, nc, T, H, W, 3] -> unit embeddings [B, 300] float32; `model`
    must be in eval mode (BN running statistics, no dropout, no autograd)."""
    with torch.inference_mode():
        return model(x)
