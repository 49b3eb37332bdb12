"""Zero-shot evaluation: embeddings -> cosine-NN classification + protocols.

Counterpart of zeroshotvideoclassification_tpu/eval/zeroshot.py (parity
targets: reference/main.py:224-325), for one process.
  * compute_accuracy: top-1 via argmin cosine distance; ground truth derived
    from TRUE embeddings (argmin of their distance to class embeds — NOT the
    integer labels; main.py:321-323); top-5 via membership in the 5 nearest.
  * 10-seeded half-class split protocol: np.random.seed(split) then
    np.random.permutation(C)[:C//2] — reproduced bit-exactly with
    np.random.RandomState(split) (identical MT19937 stream).
The distance/top-k math runs in torch (ops/cdist.py) on the device it is
given. Under a process group extract_embeddings gathers every process's
rows in rank order, so every process computes the metrics of the whole
table.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, Optional, Tuple

import numpy as np
import torch

from zeroshotvideoclassification_tpu_torch.ops.cdist import (
    nearest_class,
    topk_classes,
)
from zeroshotvideoclassification_tpu_torch.parallel.multihost import (
    gather_rows,
    group_active,
    sync_processes,
)


def compute_accuracy(
    predicted_embed: np.ndarray,
    class_embed: np.ndarray,
    true_embed: np.ndarray,
    device="cpu",
) -> Tuple[float, float]:
    """-> (top1 %, top5 %). Parity: main.py:316-325. The distances are taken
    on `device`."""
    if len(predicted_embed) != len(true_embed):
        raise ValueError("True and predicted labels must have the same "
                         "number of samples")

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(device)

    ce = dev(class_embed)
    top5 = topk_classes(dev(predicted_embed), ce, k=5).cpu().numpy()
    y = nearest_class(dev(true_embed), ce).cpu().numpy()
    top1_acc = float(np.mean(y == top5[:, 0]) * 100)
    top5_acc = float(np.mean([l in p for l, p in zip(y, top5)]) * 100)
    return top1_acc, top5_acc


def split_protocol(
    predicted_embed: np.ndarray,
    class_embed: np.ndarray,
    true_label: np.ndarray,
    true_embed: np.ndarray,
    n_splits: int = 10,
    device="cpu",
) -> Dict[str, float]:
    """10-seeded random half-class splits -> mean/std top1 & top5.

    Parity: main.py:278-300 (including the seeded permutation semantics)."""
    acc = np.zeros(n_splits)
    acc5 = np.zeros(n_splits)
    n_classes = len(class_embed)
    for split in range(n_splits):
        # identical stream to np.random.seed(split); np.random.permutation(C)
        sel_classes = np.random.RandomState(split).permutation(n_classes)[
            : n_classes // 2]
        sel = np.isin(true_label, sel_classes)
        a, a5 = compute_accuracy(
            predicted_embed[sel], class_embed[sel_classes], true_embed[sel],
            device)
        acc[split], acc5[split] = a, a5
    return {
        "accuracy_split_mean": float(acc.mean()),
        "accuracy_split_std": float(acc.std()),
        "accuracy_split_top5_mean": float(acc5.mean()),
        "accuracy_split_top5_std": float(acc5.std()),
        "n_split_classes": n_classes // 2,
    }


def extract_embeddings(
    eval_step: Callable[[torch.Tensor], torch.Tensor],
    batches: Iterable[Dict[str, torch.Tensor]],
    lookahead: bool = True,
    sync_tag: Optional[str] = None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Run `eval_step` (x -> embeddings [B, 300]) over an iterable of
    evaluation batches.

    Each batch: dict with 'x' [B, nc, T, H, W, 3], 'z' [B, 300],
    'label' [B], 'weight' [B] (0 marks broken/padding samples — the
    reference's label==-1 convention, main.py:246-247).
    Returns (pred_embed [N,300], true_embed [N,300], true_label [N]) of the
    rows with weight > 0, in order.

    Under a process group each process passes its lockstep shard of the
    table; every batch's [emb, z, weight, label] is packed into ONE float32
    [B, 2*300+2] tensor on the device and gathered in rank order
    (parallel.multihost.gather_rows), as eval/zeroshot.py:119-137 of the
    JAX package gathers its global array, so every process returns the
    rows of the whole table. Labels ride the float32 pack exactly (class
    counts are far below 2**24). `sync_tag` (unique per call site) aligns
    the processes before the first dispatch.

    One-batch lookahead: batch k+1 is DISPATCHED before batch k's result is
    fetched. CUDA launches are asynchronous, but the fetch (`.cpu()` of the
    embeddings) blocks — without the lookahead the device sits idle through
    every inter-batch host gap (generator next() = H2D upload + transform
    dispatch; decode itself is already prefetched by HostPipeline). Costs
    one extra in-flight batch of device memory; eval holds no activations,
    so that is cheap. `lookahead=False` collects each batch synchronously:
    the control for measuring what the lookahead buys. Results are
    collected strictly in order either way, and every process runs the same
    sequence of dispatches and gathers."""
    preds, trues, labels = [], [], []
    multi = group_active()

    def dispatch(batch):
        """The step (and, under a group, the pack and its gather)."""
        emb = eval_step(batch["x"])
        if not multi:
            return emb, batch
        packed = torch.cat([emb.float(), batch["z"].float(),
                            batch["weight"].float()[:, None],
                            batch["label"].float()[:, None]], dim=1)
        return gather_rows(packed), None

    def collect(pending):
        """Blocking fetch + host-side accumulation (in submission order)."""
        dev, batch = pending
        if batch is None:
            packed = dev.cpu().numpy()
            d = packed.shape[1] // 2 - 1
            emb_h, z_h = packed[:, :d], packed[:, d:2 * d]
            w_h = packed[:, 2 * d]
            lab_h = packed[:, 2 * d + 1].astype(np.int64)
        else:
            emb_h = dev.float().cpu().numpy()
            z_h = batch["z"].cpu().numpy()
            w_h = batch["weight"].cpu().numpy()
            lab_h = batch["label"].cpu().numpy()
        keep = w_h > 0
        preds.append(emb_h[keep])
        trues.append(z_h[keep])
        labels.append(lab_h[keep])

    pending = None
    for i, batch in enumerate(batches):
        if i == 0 and sync_tag:
            sync_processes(sync_tag)
        cur = dispatch(batch)
        if not lookahead:
            collect(cur)
            continue
        if pending is not None:
            collect(pending)
        pending = cur
    if pending is not None:
        collect(pending)
    return (
        np.concatenate(preds, axis=0),
        np.concatenate(trues, axis=0),
        np.concatenate(labels, axis=0),
    )


def evaluate_dataset(
    eval_step: Callable[[torch.Tensor], torch.Tensor],
    batches: Iterable[Dict[str, torch.Tensor]],
    class_embed: np.ndarray,
    split: int = -1,
    name: str = "",
    device="cpu",
) -> Dict[str, float]:
    """Full per-dataset evaluation (main.py:224-313): full-set accuracy plus
    the 10-split protocol when split == -1."""
    pred, true_emb, true_lab = extract_embeddings(eval_step, batches)
    top1, top5 = compute_accuracy(pred, class_embed, true_emb, device)
    out = {"name": name, "accuracy": top1, "accuracy_top5": top5,
           "n_samples": int(len(pred))}
    if split == -1:
        out.update(split_protocol(pred, class_embed, true_lab, true_emb,
                                  device=device))
    return out
