"""Multi-device dry run: one full training step and the evaluation forward
of the flagship model over n processes, one device each, as a dp x tp
grid.

Counterpart of the JAX repository's __graft_entry__.dryrun_multichip: the
same model (r2plus1d_18 + the mlp head, float32), Config(bs=n), the same
tiny global batch of max(n, 2) clips of 1x4x32x32x3 drawn from
np.random.default_rng(0) in the same order, and the same grid rule (the
head's tensor parallelism tp 4 at n >= 32 where 4 divides n, tp 2 at even
n >= 4, else 1; parallel.init_grid). Each process takes its data shard of
the rows (a model group's processes share theirs), runs one train step
(BN statistics, the loss and the gradients over the global batch; the
head's product over the model group) and the evaluation forward on the
same rows, gathered in data-index order, and checks that the loss and
the embeddings are finite. Process 0 prints

  dryrun_multichip OK: mesh={'data': D, 'model': T} loss=L

The processes are spawned (parallel.multihost.run_local_ranks): NCCL on
CUDA with rank r on cuda:r (n above the visible GPUs raises), or, where the
caller names backend="gloo", gloo with every process on cuda:0; gloo on the
CPU. There is no fallback from one backend to another.

  python -m zeroshotvideoclassification_tpu_torch.dryrun 8 --device cpu
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time
from typing import Optional

import numpy as np
import torch

RESULT = "dryrun_result.json"


def grid_tp(n: int) -> int:
    """The 'model' axis of n devices (the JAX dry run's rule)."""
    if n % 4 == 0 and n >= 32:
        return 4
    return 2 if n % 2 == 0 and n >= 4 else 1


def global_batch(n: int):
    """(x, z, labels, weight, class_embed) of the dry run's global batch of
    max(n, 2) clips, drawn as the JAX dry run draws them."""
    b = max(n, 2)
    rng = np.random.default_rng(0)
    x = rng.uniform(-0.5, 0, (b, 1, 4, 32, 32, 3)).astype(np.float32)
    z = rng.normal(size=(b, 300)).astype(np.float32)
    z /= np.linalg.norm(z, axis=1, keepdims=True)
    labels = rng.integers(0, 4, size=b).astype(np.int32)
    weight = np.ones(b, np.float32)
    class_embed = rng.normal(size=(4, 300)).astype(np.float32)
    return x, z, labels, weight, class_embed


def dryrun_step(n: int, device="cuda") -> dict:
    """One float32 train step and the evaluation forward of the dry run of
    n devices, in this process, on its data shard of the global batch under
    the grid parallel.init_grid built (the whole batch without a process
    group). -> {"loss", "emb" (the gathered [max(n, 2), 300] float32
    numpy embeddings), "step_seconds" (the host's clock around the step
    and the read of its loss)}. TF32 is off, as in
    cli/infer.build_scoring_state."""
    from zeroshotvideoclassification_tpu_torch.cli.infer import resolve_device
    from zeroshotvideoclassification_tpu_torch.config import Config
    from zeroshotvideoclassification_tpu_torch.models import get_network
    from zeroshotvideoclassification_tpu_torch.models.layers import (
        init_weights,
    )
    from zeroshotvideoclassification_tpu_torch.parallel import (
        gather_rows,
        grid,
    )
    from zeroshotvideoclassification_tpu_torch.train import (
        eval_step,
        make_optimizer,
        make_train_step,
    )

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    device = resolve_device(device)
    g = grid()
    config = Config(network="r2plus1d_18", head="mlp", bs=n)
    model = get_network(config)
    init_weights(model, torch.Generator().manual_seed(0))
    model.shard_head(g.tp, g.model_index)
    model = model.to(device=device, memory_format=torch.channels_last_3d)
    optimizer = make_optimizer(model.parameters(), config.lr)
    step = make_train_step(model, optimizer, compute_dtype=torch.float32)
    data = global_batch(n)
    per = data[0].shape[0] // g.n_data
    rows = slice(g.data_index * per, (g.data_index + 1) * per)
    x, z, labels, weight = (torch.from_numpy(a[rows]).to(device)
                            for a in data[:4])
    class_embed = torch.from_numpy(data[4]).to(device)
    t0 = time.perf_counter()
    metrics = step(x, z, labels, weight, class_embed)
    loss = float(metrics["loss"])  # waits for the step
    seconds = time.perf_counter() - t0
    if not np.isfinite(loss):
        raise FloatingPointError(f"dry run: the loss is {loss}")
    model.eval()
    emb = gather_rows(eval_step(model, x)).float().cpu().numpy()
    if emb.shape != (data[0].shape[0], 300) or not np.all(np.isfinite(emb)):
        raise FloatingPointError(f"dry run: embeddings {emb.shape}, finite "
                                 f"{np.isfinite(emb).all()}")
    return {"loss": loss, "emb": emb, "step_seconds": seconds}


def _rank(n: int, device_type: str, out_dir: str) -> None:
    """One spawned process of the dry run (run_local_ranks has joined the
    group): the grid, the step and, on process 0, the line and the
    result file, with the K2 launches this process counted."""
    from zeroshotvideoclassification_tpu_torch.ops.bn_cuda import (
        bn_apply_relu_bwd_cuda,
        bn_apply_relu_cuda,
    )
    from zeroshotvideoclassification_tpu_torch.parallel import (
        init_grid,
        make_mesh,
        process_index,
    )

    tp = grid_tp(n)
    mesh = make_mesh((n // tp, tp), ("data", "model"))
    init_grid(tp)
    if device_type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
    else:
        device = torch.device("cpu")
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // n))
    counters = (bn_apply_relu_cuda, bn_apply_relu_bwd_cuda)
    before = [c.launches for c in counters]
    res = dryrun_step(n, device)
    if process_index() == 0:
        print(f"dryrun_multichip OK: mesh={mesh} loss={res['loss']:.5f}",
              flush=True)
        launches = {name: c.launches - b for name, c, b in zip(
            ("bn_apply_relu", "bn_apply_relu_bwd"), counters, before)}
        with open(os.path.join(out_dir, RESULT), "w") as f:
            json.dump({"mesh": mesh, "loss": res["loss"],
                       "step_seconds": res["step_seconds"],
                       "launches": launches}, f)


def dryrun_multichip(n_devices: int = 8, device="cuda",
                     backend: Optional[str] = None) -> dict:
    """Run the dry run on n_devices spawned processes (module docstring).
    -> process 0's {"mesh": {"data": D, "model": T}, "loss": L,
    "step_seconds", "launches": its K2 forward and backward launches}. Raises if any process fails, if
    NCCL is asked for more processes than there are GPUs, or for a backend
    the device does not take."""
    from zeroshotvideoclassification_tpu_torch.cli.infer import resolve_device
    from zeroshotvideoclassification_tpu_torch.parallel.multihost import (
        run_local_ranks,
    )

    device = resolve_device(device)
    if device.type == "cuda":
        backend = backend or "nccl"
        if backend == "nccl" and n_devices > torch.cuda.device_count():
            raise ValueError(
                f"dryrun_multichip({n_devices}) under NCCL needs "
                f"{n_devices} GPUs, {torch.cuda.device_count()} are "
                f"visible (backend='gloo' puts every process on cuda:0)")
    elif (backend or "gloo") != "gloo":
        raise ValueError(f"backend {backend!r} on {device}: the CPU runs "
                         f"gloo")
    with tempfile.TemporaryDirectory(prefix="zsvc_dryrun_") as tmp:
        run_local_ranks(_rank, (n_devices, device.type, tmp), n_devices,
                        f"file://{os.path.join(tmp, 'store')}",
                        device_type=device.type, backend=backend)
        with open(os.path.join(tmp, RESULT)) as f:
            return json.load(f)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("n_devices", type=int, nargs="?", default=8)
    p.add_argument("--device", default="cuda",
                   help="cuda (NCCL, rank r on cuda:r) or cpu (gloo); cuda "
                        "without a GPU is an error")
    args = p.parse_args(argv)
    return dryrun_multichip(args.n_devices, args.device)


if __name__ == "__main__":
    main()
