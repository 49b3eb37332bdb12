"""The plain reference of the train cells: the input transform of the staged
canvases, the forward, the masked MSE, the backward and Adam, in float32
with TF32 off, over the same seeded weights and host batches the program
was given. It follows the program's first steps and returns what the
comparison reads: each step's loss, every parameter's first gradient norm
and its change after the steps.

Under a process group (the data-parallel cell) every process runs this on
its own shard, with the batch statistics, the loss's weight sum and the
gradients over the global batch.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch
import torch.distributed as dist

from benchmark.reference.models import Net, identity

BETAS = (0.9, 0.999)
ADAM_EPS = 1e-8


def transform(canvas, y0, y1, wy, x0, x1, wx, n_clips: int, clip_len: int,
              device) -> torch.Tensor:
    """uint8 canvases [B, F, H, W, 3] and per-sample taps [B, S] -> clips
    [B, n_clips, clip_len, S, S, 3] float32: bilinear rows, then columns,
    then ((v / 255) - 1) / 2, the reference chain's [-0.5, 0] range."""
    def dev(a, dtype):
        return torch.as_tensor(a).to(device=device, dtype=dtype)

    c = dev(canvas, torch.float32)
    b, f, h, w, ch = c.shape
    s = y0.shape[1]
    iy0, iy1 = dev(y0, torch.int64), dev(y1, torch.int64)
    ix0, ix1 = dev(x0, torch.int64), dev(x1, torch.int64)
    fy = dev(wy, torch.float32).view(b, 1, s, 1, 1)
    fx = dev(wx, torch.float32).view(b, 1, 1, s, 1)

    def rows(i):
        return torch.gather(c, 2, i.view(b, 1, s, 1, 1).expand(b, f, s, w, ch))

    r = rows(iy0) * (1 - fy) + rows(iy1) * fy
    del c

    def cols(i):
        return torch.gather(r, 3, i.view(b, 1, 1, s, 1).expand(b, f, s, s, ch))

    v = cols(ix0) * (1 - fx) + cols(ix1) * fx
    v = ((v / 255.0) - 1.0) / 2.0
    return v.view(b, n_clips, clip_len, s, s, ch)


def _all_sum(t: torch.Tensor, synced: bool) -> torch.Tensor:
    if synced:
        dist.all_reduce(t)
    return t


def follow(net: Net, params0: Dict[str, torch.Tensor], batches: List[dict],
           n_clips: int, clip_len: int, lr: float, device,
           quant=identity, synced: bool = False,
           dropout: Optional[tuple] = None) -> dict:
    """Take len(batches) steps of Adam(lr) from params0 on `batches` (dicts
    of the host batch's arrays: canvas, the six taps, z, weight).

    -> {"loss": [global loss a step], "grad": {name: norm of the first
    step's gradient}, "delta": {name: norm of the change over the
    steps}}."""
    # plain float32: no TF32, cuDNN's heuristics rather than its timing
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.benchmark = False
    names = [k for k in params0 if not k.endswith(("running_mean",
                                                  "running_var"))]
    P = {k: params0[k].detach().clone().requires_grad_(True) for k in names}
    m = {k: torch.zeros_like(P[k]) for k in names}
    v = {k: torch.zeros_like(P[k]) for k in names}
    b1, b2 = BETAS
    losses, first = [], None
    for t, hb in enumerate(batches, 1):
        x = transform(hb["canvas"], hb["y0"], hb["y1"], hb["wy"], hb["x0"],
                      hb["x1"], hb["wx"], n_clips, clip_len, device)
        z = torch.as_tensor(hb["z"]).to(device)
        w = torch.as_tensor(hb["weight"]).to(device)
        with torch.enable_grad():
            emb = net.forward(P, x, train=True, quant=quant, synced=synced,
                              dropout=dropout, remat=True)
            del x
            per = torch.mean(torch.square(emb - z), dim=-1)
            wsum = _all_sum(w.sum(), synced)
            loss = torch.sum(per * w) / torch.clamp_min(wsum, 1.0)
            grads = torch.autograd.grad(loss, [P[k] for k in names])
        if synced:
            flat = torch.cat([g.reshape(-1) for g in grads])
            dist.all_reduce(flat)
            grads = [f.view_as(g) for f, g in zip(
                flat.split([g.numel() for g in grads]), grads)]
        losses.append(float(_all_sum(loss.detach().clone(), synced)))
        if first is None:
            first = {k: float(torch.linalg.vector_norm(g))
                     for k, g in zip(names, grads)}
        with torch.no_grad():
            bc1, bc2 = 1 - b1 ** t, 1 - b2 ** t
            for k, g in zip(names, grads):
                m[k].mul_(b1).add_(g, alpha=1 - b1)
                v[k].mul_(b2).addcmul_(g, g, value=1 - b2)
                denom = (v[k].sqrt() / bc2 ** 0.5).add_(ADAM_EPS)
                P[k].addcdiv_(m[k], denom, value=-lr / bc1)
        del grads
    delta = {k: float(torch.linalg.vector_norm(P[k].detach() - params0[k]))
             for k in names}
    return {"loss": losses, "grad": first, "delta": delta}
