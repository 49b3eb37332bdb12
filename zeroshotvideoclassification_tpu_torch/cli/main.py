"""Training and evaluation entry point with reference CLI parity, on one
GPU or on several processes with one GPU each.

Counterpart of zeroshotvideoclassification_tpu/cli/main.py: build the
datasets, then per epoch set the learning rate from the MultiStepLR
schedule, iterate the host pipeline (seeded with seed + epoch,
sample-capped like reference/main.py:208), move each host batch to the
device (pinned H2D + the transform: K1 for videos, the antialiased
transform or K4 for still images), take one train step (train/step.py: K2
forward and backward in every epilogue, guarded Adam) or, with
--steps_per_call K > 1, stage it for a group of K steps, log every
`log_every` steps (by count, so the cadence does not change with K); then
evaluate every test table zero-shot (full set +
the 10-split protocol), track the best mean accuracy, and print the
reference's per-epoch lines. A still-image training table (--dataset
sun2both: train on SUN, test on videos) trains with the halved batch.

  python -m zeroshotvideoclassification_tpu_torch.cli.main \
      --dataset synthetic --class_total 8 --train_samples 64 \
      --n_epochs 2 --bs 8 --network r2plus1d_18 --device cuda

Checkpoints are the JAX package's npz files (train/checkpoint.py), so
either package resumes, warm-starts from or evaluates the other's. An
epoch that improves the best mean accuracy writes <run>/checkpoint.npz;
--checkpoint_every N writes <run>/last.npz every N epochs; both go through
one writer thread (train/async_ckpt.py), drained before run() returns.
--resume PATH restores the full state (parameters, BN statistics, Adam's
moments and counters, the step count) and goes on at the epoch after the
saved one in the checkpoint's directory; --resume auto takes the newest
checkpoint of this run's name, or starts fresh where there is none.
--weights PATH warm-starts (every tensor whose key and shape match, from
an npz, a torchvision / reference .pth or C3D's c3d.pickle); without
--nopretrained a <pretrained_dir>/<network>.{npz,pth,pth.tar} (for C3D
also ./assets/c3d.pickle) is loaded the same way.
--evaluate evaluates --weights or the run's checkpoint.npz (strict on the
weights and BN statistics) once. --profile_dir traces the first epoch with
torch.profiler.

Every model of the JAX package trains here (models/heads.get_network):
--network r2plus1d_18 / r3d_18 / mc3_18 / c3d / resnet18 (R3D-18 with the
linear head), --head mlp / linear, --clip_pool feature / embedding,
--fixconvs, --remat [full|convs]. The linear and C3D heads' dropout draws
its masks from a generator on the model's device, seeded per epoch with
dropout_seed: (seed << 16) + epoch, plus data index x an odd 32-bit
constant on the processes of a group (each data shard draws its own masks,
on the CPU too, whose generator keeps 32 bits of its seed; the processes
of a model group, which see the same rows, draw the same).

Data parallelism (parallel/): under torchrun (its WORLD_SIZE / RANK /
LOCAL_RANK), or where a caller opened a process group (as the tests' and
chip_smoke.py's workers do), every process trains a replica on its
lockstep shard of each global batch of --bs x the 'data' axis (the number
of processes), with BN statistics, the loss and the gradients over the
global batch, evaluates its shard of each test table and gathers the rows
of all; process 0 decides the run directory and --resume auto and alone
writes the CSV, JSONL, stamp and checkpoint files. A plain launch with
--device cuda on a host that shows several GPUs runs one process per GPU
(spawned here; NCCL) and returns process 0's summary, as the JAX package
uses every device of its mesh; --device cuda:N or cpu runs one process.

  torchrun --nproc_per_node 2 -m zeroshotvideoclassification_tpu_torch.cli.main \
      --dataset synthetic --class_total 8 --train_samples 16 --bs 4 \
      --size 32 --clip_len 8 --device cpu --nopretrained

--tp N (the head's tensor parallelism, as the JAX package's 'model' mesh
axis): the P processes form a (P / N) x N grid (parallel.init_grid; rank r
at data r // N, model r % N). The N processes of a model group read the
same data shard of each global batch of --bs x P / N, and each holds one
shard of the mlp head (models/heads.MLP.shard: fc1's columns, fc2's rows
in the JAX layout) beside a replica of the backbone; BN statistics, the
loss and the shards' gradients are summed over the data group, the
replicas' gradients over every process / N, and the head's product over
the model group. The linear and C3D heads are replicated.
Checkpoints hold the head whole (process 0 gathers its model group's
shards), so a --tp 2 checkpoint loads at --tp 1 in either package and the
other way round. A --tp that does not divide the processes, or the mlp
head's 512 features, raises ValueError before any dataset is built.

  torchrun --nproc_per_node 2 -m zeroshotvideoclassification_tpu_torch.cli.main \
      --dataset synthetic --class_total 8 --train_samples 16 --bs 4 \
      --size 32 --clip_len 8 --device cpu --nopretrained --tp 2

--steps_per_call K (> 1) takes K steps a dispatch, as the JAX package's
scan-fused step: on a GPU one replay of a CUDA graph of K steps
(train/step.make_scan_train_step; the run's first group runs eagerly and is
then captured, once; an epoch's partial last group replays a one-step
graph), on the CPU the same steps one after the other. The graphs capture
the collectives of a process group, so a CUDA run under a gloo group
refuses K > 1 before any dataset is built. --debug_nans reads every
dispatch's losses and the guard's flags on the host and raises
FloatingPointError naming the first step that is not finite (the guard has
skipped its update; a group's later steps were taken); on the eager paths
(the CPU, or K = 1) the step also runs under
torch.autograd.detect_anomaly(check_nan=True), so that the error names the
backward op that made the NaN. Without it nothing syncs: the guard skips
such a step on the device.

The flags are the JAX trainer's (config.build_arg_parser, the same Config)
plus --device, which defaults to cuda (cuda:LOCAL_RANK under a process
group); asking for cuda without a GPU raises. --save_samples writes, on
process 0, the first clip of each epoch's first batch (its local host
batch through the transform, float32) as
<run>/samples/samples_train_epoch<E>_<class>.gif (utils/gif.py); any error
of that dump (imageio missing, a full disk) is a warning on stderr and the
run goes on, as in the JAX package.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
from typing import Dict, List

import numpy as np
import torch

from zeroshotvideoclassification_tpu_torch.cli.infer import resolve_device
from zeroshotvideoclassification_tpu_torch.config import (
    Config,
    build_arg_parser as build_config_parser,
    config_from_namespace,
    torch_dtype,
    transform_dtype,
)
from zeroshotvideoclassification_tpu_torch.data.datasets import (
    VideoTable,
    build_datasets,
)
from zeroshotvideoclassification_tpu_torch.data.pipeline import (
    HostPipeline,
    device_batch,
)
from zeroshotvideoclassification_tpu_torch.eval import (
    compute_accuracy,
    extract_embeddings,
    split_protocol,
)
from zeroshotvideoclassification_tpu_torch.models import get_network
from zeroshotvideoclassification_tpu_torch.models.heads import (
    check_tensor_parallel,
)
from zeroshotvideoclassification_tpu_torch.models.layers import init_weights
from zeroshotvideoclassification_tpu_torch.parallel import (
    agree_from_process_zero,
    init_grid,
    make_mesh,
    maybe_initialize,
    process_count,
    process_index,
    shard_table,
    sync_processes,
)
from zeroshotvideoclassification_tpu_torch.parallel.multihost import (
    broadcast_from_model,
    check_capturable,
    destroy,
    group_active,
    local_rank,
    run_local_ranks,
)
from zeroshotvideoclassification_tpu_torch.train import (
    eval_step,
    host_state,
    load_checkpoint,
    make_optimizer,
    make_scan_train_step,
    make_train_step,
    multistep_lr,
    raise_if_not_finite,
    read_meta,
    set_lr,
    warm_start,
)
from zeroshotvideoclassification_tpu_torch.utils.logging import (
    MetricsLogger,
    Timer,
    colored,
)


def _find_latest_checkpoint(base: str):
    """Newest full-state checkpoint for --resume auto: last.npz (periodic)
    or checkpoint.npz (best-by-accuracy) under the base savename or any of
    its _N dedup dirs; None if the run never checkpointed. Ranked by the
    checkpoint's STORED epoch (read_meta), not the file's mtime; last.npz
    wins epoch ties (it is written after checkpoint.npz in an epoch)."""
    import glob
    import zipfile

    candidates = []
    for d in [base] + sorted(glob.glob(base + "_*")):
        for pref, name in enumerate(("checkpoint.npz", "last.npz")):
            p = os.path.join(d, name)
            if os.path.exists(p):
                try:
                    epoch = int(read_meta(p).get("epoch", -1))
                except (OSError, ValueError, KeyError, EOFError,
                        zipfile.BadZipFile):
                    continue  # mid-write / corrupt file: not a candidate
                candidates.append((epoch, pref, p))
    return max(candidates)[2] if candidates else None


# the data index's stride in a dropout seed: odd, so that the low 32 bits
# (all a CPU torch.Generator keeps of its seed) differ for every data index
# below 2^32, and the golden ratio's 32-bit fraction, so that they stay far
# from the epoch's own offsets
SHARD_SEED_STRIDE = 0x9E3779B9


def dropout_seed(seed: int, epoch: int, data_index: int) -> int:
    """The seed of data shard `data_index`'s dropout generator in `epoch`:
    (seed << 16) + epoch at data index 0 (one process, --tp 1, and the
    first data shard of a group), plus data_index * SHARD_SEED_STRIDE on the
    others. The members of a model group share their data index, so they
    draw the same masks."""
    return (seed << 16) + epoch + data_index * SHARD_SEED_STRIDE


def eval_batch_size(global_bs: int, n_clips: int, n_data: int,
                    process_count: int, table_len: int,
                    clip_budget: int) -> int:
    """Videos per global eval dispatch.

    Starts from the reference's per-video batch scaled down by clips/video
    (dataset.py:75,131) — a GPU-memory-motivated scale-down — then floors the
    CLIP count per device at ``clip_budget``: the forward amortizes with
    batch and eval numerics are per-sample (running-stat BN), so a bigger
    batch only changes the zero-weight tail padding. Rounded up to a
    multiple of lcm(n_data, process_count) so batches both shard evenly over
    the devices and split evenly across processes (the port's trainer
    passes process_count 1, as the JAX package on one process over the
    same mesh, and splits the batch over its n_data data shards), then
    capped at the table size (same rounding) so tiny test sets don't
    dispatch mostly padding.

    clip_budget == 0 restores the reference batch sizing EXACTLY (no clip
    floor and no tiny-table cap — only the divisibility rounding).
    """
    n_clips = max(n_clips, 1)
    bs = max(global_bs // n_clips, 1)
    mult = n_data * process_count // np.gcd(n_data, process_count)
    if clip_budget == 0:
        return ((bs + mult - 1) // mult) * mult
    want_clips = clip_budget * n_data
    bs = max(bs, (want_clips + n_clips - 1) // n_clips)
    bs = ((bs + mult - 1) // mult) * mult
    return min(bs, ((table_len + mult - 1) // mult) * mult)


def rank_device(device) -> torch.device:
    """The device of this process: `device`, where `cuda` without an index
    means cuda:LOCAL_RANK under a process group; cuda without a GPU
    raises."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None and group_active():
        device = torch.device("cuda", local_rank())
    return resolve_device(device)


class Experiment:
    """Bundles model, optimizer, steps and logging for one run (one process
    of a data-parallel group, or the only one)."""

    def __init__(self, config: Config,
                 datasets: Dict[str, List[VideoTable]], device="cuda"):
        self.config = config
        self.datasets = datasets
        self.device = rank_device(device)
        # full float32 where float32 is asked for, and cuDNN timing its
        # algorithms per conv shape, as cli/infer.build_scoring_state
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.benchmark = True
        self.rank, self.world = process_index(), process_count()
        mesh = make_mesh(config.mesh_shape, config.mesh_axes, self.world)
        self.n_data = mesh.get("data", 1)
        # every data group and model group, before the first collective
        self.grid = init_grid(mesh.get("model", 1))
        # reference: bs * n_gpus (main.py:61-63); each data shard (a model
        # group's processes share theirs) is a lockstep share of the
        # global batch
        self.global_bs = config.bs * self.n_data
        self.local_bs = self.global_bs // self.n_data
        train_tables = datasets.get("training") or []
        self.train_bs, self.train_local_bs = self.global_bs, self.local_bs
        if (train_tables and train_tables[0].loader == "image"
                and config.class_total != 0):
            # checked here, at construction, not at the first epoch
            self.train_bs, self.train_local_bs = self._image_train_batch()
        self.model = get_network(config)
        init_weights(self.model, torch.Generator().manual_seed(config.seed))
        # --tp: this process's shard of the whole (seeded) head
        self.model.shard_head(self.grid.tp, self.grid.model_index)
        self.model = self.model.to(device=self.device,
                                   memory_format=torch.channels_last_3d)
        self.optimizer = make_optimizer(self.model.parameters(), config.lr)
        self.lr_at = multistep_lr(config.lr, config.n_epochs)
        self.dtype = torch_dtype(config.compute_dtype)
        # --steps_per_call K > 1: K steps a dispatch (CUDA graphs on a GPU)
        # over the same state as the single step, which drains a tail
        self.scan_step = None
        if config.steps_per_call > 1:
            self.scan_step = make_scan_train_step(
                self.model, self.optimizer, self.dtype,
                config.steps_per_call)
            self.train_step = self.scan_step.single
        else:
            self.train_step = make_train_step(self.model, self.optimizer,
                                              compute_dtype=self.dtype)
        # dropout's masks are drawn where the model is, from one generator
        # reseeded every epoch (a CUDA graph holds the one it captured with)
        self.rng = torch.Generator(self.device)
        self.start_epoch = 0
        self.best_acc = 0.0
        base = config.savename(self.n_data)
        if config.resume == "auto":
            # preemption recovery: the newest full-state checkpoint under
            # this run's name (and its _N dirs); a fresh run if there is
            # none. Process 0 chooses and every process takes its choice.
            found = agree_from_process_zero(
                _find_latest_checkpoint(base) if self.rank == 0 else None)
            config = config.replace(resume=found)
            self.config = config
            print(f"RESUME auto: {found or 'no checkpoint found, fresh run'}")
        if config.resume:
            meta = load_checkpoint(config.resume, self.model, self.optimizer)
            self.train_step.state.step = meta["step"]
            self.start_epoch = int(meta.get("epoch", -1)) + 1
            self.best_acc = float(meta.get("accuracy", 0.0))
            print(f"RESUMED: {config.resume} at epoch {self.start_epoch}")
        if config.evaluate:
            # --evaluate points at --weights or the run's best checkpoint and
            # logs to an evaluation/ subdir (reference/main.py:102-104)
            ckpt = (config.weights if config.weights
                    and config.weights != "none"
                    else os.path.join(base, "checkpoint.npz"))
            if os.path.exists(ckpt):
                # the weights and BN statistics only, strictly
                meta = load_checkpoint(
                    ckpt, self.model, strict_sections=("params",
                                                       "model_state"))
                print(f"LOADED CHECKPOINT: {ckpt} (epoch "
                      f"{meta.get('epoch')}, acc {meta.get('accuracy')})")
            else:
                print(f"WARNING: no checkpoint at {ckpt}; evaluating fresh "
                      f"init")
            self.savename = os.path.join(base, "evaluation")
        elif config.resume:
            self.savename = os.path.dirname(config.resume) or base
        else:
            if config.weights and config.weights != "none":
                n = warm_start(config.weights, self.model)
                print(f"LOADED MODEL: {config.weights} ({n} tensors)")
            elif not config.nopretrained:
                self._warm_start_pretrained()
            # de-dup the experiment dir with a _N suffix
            # (reference/main.py:94-97), on process 0, which claims the
            # directory before the others take its name
            found = None
            if self.rank == 0:
                found, count = base, 1
                while os.path.exists(found):
                    found = base + f"_{count}"
                    count += 1
                os.makedirs(found)
            self.savename = agree_from_process_zero(found)
        # every file of the run is written by process 0 alone
        self.writer = self.rank == 0
        if self.writer:
            os.makedirs(self.savename, exist_ok=True)
        self.log = MetricsLogger(self.savename, write=self.writer)
        self._ckpt = None  # the writer thread, started at the first write
        # the other processes wait while process 0 writes, so that the
        # first step's collectives start together
        sync_processes("init_placement")

    def _ckpt_writer(self):
        """This run's AsyncCheckpointer: writes on one ordered thread, so
        that the next epoch's steps overlap the disk write."""
        if self._ckpt is None:
            from zeroshotvideoclassification_tpu_torch.train.async_ckpt \
                import AsyncCheckpointer

            self._ckpt = AsyncCheckpointer()
        return self._ckpt

    def agree_bn_statistics(self) -> None:
        """Under --tp, BN's running means and variances become those of the
        model group's first member (one broadcast over the model group),
        before each evaluation and each checkpoint: the replicas hold equal
        parameters, but on a GPU each process's cuDNN may compute the
        forward that moves the statistics with other bits, and the JAX
        package holds one replicated state. Nothing without a model
        axis."""
        broadcast_from_model([b for n, b in self.model.named_buffers()
                              if n.endswith(("running_mean",
                                             "running_var"))])

    # -------------------------------------------------------- pretrained ----
    def _warm_start_pretrained(self) -> None:
        """Without --nopretrained, load <pretrained_dir>/<network>.npz,
        .pth or .pth.tar, or for C3D ./assets/c3d.pickle (the first that
        exists) as a warm start: the counterpart of the reference's
        pretrained=True torchvision constructors (reference/resnet.py:
        284-362) and of its C3D load (network.py:129-130)."""
        cfg = self.config
        candidates = [os.path.join(cfg.pretrained_dir, f"{cfg.network}.{ext}")
                      for ext in ("npz", "pth", "pth.tar")]
        if "c3d" in cfg.network:
            candidates.append("./assets/c3d.pickle")  # the reference's path
        for path in candidates:
            if os.path.exists(path):
                n = warm_start(path, self.model)
                print(f"PRETRAINED: loaded {n} tensors from {path}")
                return
        print(f"WARNING: no pretrained asset for {cfg.network!r} under "
              f"{cfg.pretrained_dir!r} — training from random init (pass "
              f"--nopretrained to silence this)")

    # ------------------------------------------------------------- train ----
    def train_one_epoch(self, epoch: int) -> Dict[str, float]:
        cfg = self.config
        table = self.datasets["training"][0]
        global_bs = self.train_bs
        # each process pipelines its lockstep shard of the table, from the
        # same seed (the identity with one process)
        pipe = HostPipeline(shard_table(table), cfg, self.train_local_bs,
                            seed=cfg.seed + epoch)
        class_embed = torch.from_numpy(
            np.asarray(table.class_embed, np.float32)).to(self.device)
        set_lr(self.optimizer, self.lr_at(epoch))

        batch_t, model_t = Timer(), Timer()
        losses, accs = [], []
        # each data shard draws its own masks, as the JAX package draws one
        # over the global batch; a model group's processes draw the same
        rng = self.rng.manual_seed(
            dropout_seed(cfg.seed, epoch, self.grid.data_index))
        it = iter(pipe)
        if cfg.progressbar:
            try:
                from tqdm import tqdm

                it = iter(tqdm(pipe, total=len(pipe),
                               desc=f"Epoch {epoch} Training..."))
            except ImportError:
                pass
        i = 0
        last_logged = 0
        scan = self.scan_step
        pending = 0  # batches staged in the scan step's slots
        # the steps that run eagerly, where --debug_nans can name the op
        eager = scan is None or self.device.type == "cpu"

        def dispatch(call):
            """Run one dispatch (a step, a group or a tail) and keep its
            metrics; under --debug_nans read them on the host first."""
            first = self.train_step.state.step + 1
            if cfg.debug_nans and eager:
                try:
                    with torch.autograd.detect_anomaly(check_nan=True):
                        metrics = call()
                except RuntimeError as e:
                    if "nan values" not in str(e):
                        raise
                    raise FloatingPointError(
                        f"--debug_nans: step {self.train_step.state.step + 1}"
                        f" is not finite: {e}") from e
            else:
                metrics = call()
            if cfg.debug_nans:
                raise_if_not_finite(metrics, first)
            losses.extend(metrics["loss"].reshape(-1).unbind(0))
            accs.extend(metrics["train_accuracy"].reshape(-1).unbind(0))

        def flush_pending():
            nonlocal pending
            if pending:
                n, pending = pending, 0
                dispatch(lambda: scan.run(n, class_embed, rng))

        def maybe_log():
            # count-based, so a group of K steps keeps the cadence of one
            nonlocal last_logged
            if len(losses) - last_logged >= cfg.log_every:
                step = self.train_step.state.step
                self.log.scalar("Train/Loss", float(losses[-1]), step)
                # tag parity with main_02.py:338 (there embed_loss == loss)
                self.log.scalar("Train/EmbeddingLoss", float(losses[-1]),
                                step)
                self.log.scalar("Train/RegressorAccuracy", float(accs[-1]),
                                step)
                last_logged = len(losses)

        sample_saved = not cfg.save_samples
        while True:
            with batch_t:
                host = next(it, None)
            if host is None:
                break
            if i == 0:
                # the first step's collectives start together
                sync_processes(f"train_dispatch_{epoch}")
            with model_t:
                if not sample_saved and self.rank == 0:
                    # before the batch is staged (under --steps_per_call
                    # too), as the JAX package dumps before its scan
                    self._save_sample(host, table, epoch)
                    sample_saved = True
                batch = device_batch(host, table.n_clips, cfg.clip_len,
                                     transform_dtype(cfg), self.device)
                args = batch["x"], batch["z"], batch["label"], batch["weight"]
                if scan is None:
                    dispatch(lambda: self.train_step(*args, class_embed, rng))
                else:
                    scan.stage(pending, *args)
                    pending += 1
                    if pending == scan.steps:
                        flush_pending()
            maybe_log()
            i += 1
            if i * global_bs > cfg.epoch_sample_cap:  # reference/main.py:208
                break
        with model_t:  # a partial last group: through the single step
            flush_pending()
        maybe_log()
        with model_t:  # the device's queue drains inside the model's time
            loss = float(torch.stack(losses).mean()) if losses else 0.0
            acc = float(torch.stack(accs).mean()) if accs else 0.0
        clips = i * global_bs * table.n_clips
        total_t = batch_t.total + model_t.total
        print(colored(f"Train Accuracy: regressor {acc:2.1f}%", "red"))
        print(
            "TOTAL time for: load the batch %.2f sec, run the model %.2f sec, "
            "train %.2f min | %.1f clips/sec"
            % (batch_t.total, model_t.total, total_t / 60,
               clips / max(total_t, 1e-9)))
        return {"loss": loss, "train_accuracy": acc,
                "clips_per_sec": clips / max(total_t, 1e-9)}

    def _save_sample(self, host, table: VideoTable, epoch: int) -> None:
        """--save_samples: the first clip of this process's host batch as a
        GIF (the reference's main.py:159-163, commented out there), from
        the transform's float32 output (K1, or K4 / the antialiased
        transform for still images). A debug dump must not end the run:
        any error is a warning (the JAX package's words) and training goes
        on."""
        cfg = self.config
        try:
            from zeroshotvideoclassification_tpu_torch.utils.gif import (
                batch2gif,
            )

            local = device_batch(host, table.n_clips, cfg.clip_len,
                                 torch.float32, self.device)
            sdir = os.path.join(self.savename, "samples")
            os.makedirs(sdir, exist_ok=True)
            batch2gif(
                local["x"][0, 0].cpu().numpy(), int(host.label[0]),
                os.path.join(sdir, f"samples_train_epoch{epoch}_"),
                classes=table.classes if host.label[0] >= 0 else None,
                # still images are normalised with Kinetics' mean and std,
                # not as the video chain
                mode="meanstd" if host.image_mode else "active")
        except Exception as e:  # noqa: BLE001
            print(f"WARNING: --save_samples skipped "
                  f"({type(e).__name__}: {e})", file=sys.stderr)

    def _image_train_batch(self):
        """(global, local) of the halved SUN image-train batch.

        The reference halves the image-train batch (dataset.py:26:
        `opt.bs // 2 if ... 'image' in opt.dataset ...`) — each SUN sample
        inflates to n_clips*clip_len synthetic frames, so memory per sample
        doubles vs a video clip; halved per device, each data shard a
        share."""
        global_bs = max(self.config.bs // 2, 1) * self.n_data
        return global_bs, global_bs // self.n_data

    # -------------------------------------------------------------- eval ----
    def evaluate(self, table: VideoTable, epoch: int) -> Dict[str, float]:
        cfg = self.config
        # the JAX package's global batch on one process over the same mesh
        # (its lcm(n_data, 1) rounding), split over the data shards
        eval_bs = eval_batch_size(self.global_bs, table.n_clips, self.n_data,
                                  1, len(table), cfg.eval_clip_budget)
        pipe = HostPipeline(shard_table(table), cfg, eval_bs // self.n_data,
                            seed=cfg.seed)
        source = pipe
        if cfg.progressbar:
            try:
                from tqdm import tqdm

                source = tqdm(pipe, total=len(pipe),
                              desc="Extracting features...")
            except ImportError:
                pass
        batches = (device_batch(h, table.n_clips, cfg.clip_len,
                                transform_dtype(cfg), self.device)
                   for h in source)
        self.agree_bn_statistics()
        self.model.eval()  # BN running statistics; the train step sets train
        pred, true_e, true_l = extract_embeddings(
            lambda x: eval_step(self.model, x), batches,
            sync_tag=f"eval_dispatch_{table.name}_{epoch}")
        acc, acc5 = compute_accuracy(pred, table.class_embed, true_e,
                                     self.device)
        self.log.scalar(f"{table.name}/Accuracy", acc, epoch)
        self.log.scalar(f"{table.name}/Accuracy_Top5", acc5, epoch)
        self.log.csv_append(f"{table.name}_accuracy.csv",
                            "%d, %.1f,%.1f" % (epoch, acc, acc5))
        res = f"{table.name.upper()} Epoch {epoch}: Test accuracy: {acc:2.1f}%."
        out = {"accuracy": acc, "accuracy_top5": acc5}
        # Declared parity deviation: the reference runs the 10-seeded
        # half-class split protocol unconditionally (reference/main.py:278).
        # With <4 classes a "half split" is 1 class (top-1 accuracy is
        # trivially 100%) and top-5 is meaningless, so tiny smoke/fixture
        # runs skip it; any real dataset (51+ classes) takes the reference
        # path.
        if cfg.split == -1 and len(table.classes) >= 4:
            sp = split_protocol(pred, table.class_embed, true_l, true_e,
                                device=self.device)
            out.update(sp)
            self.log.scalar(f"{table.name}/AccSplit_Mean",
                            sp["accuracy_split_mean"], epoch)
            self.log.scalar(f"{table.name}/AccSplit_Std",
                            sp["accuracy_split_std"], epoch)
            self.log.scalar(f"{table.name}/AccSplit_Mean_Top5",
                            sp["accuracy_split_top5_mean"], epoch)
            self.log.csv_append(
                f"{table.name}_accuracy_splits.csv",
                "%d, %.1f,%.1f,%.1f,%.1f" % (
                    epoch, sp["accuracy_split_mean"], sp["accuracy_split_std"],
                    sp["accuracy_split_top5_mean"], sp["accuracy_split_top5_std"]))
            res += " -- Split accuracy %2.1f%% (+-%.1f) on %d classes" % (
                sp["accuracy_split_mean"], sp["accuracy_split_std"],
                sp["n_split_classes"])
        print(colored(res, "green"))
        return out

    # --------------------------------------------------------------- loop ---
    def run(self) -> Dict[str, float]:
        cfg = self.config
        trainsamples = (len(self.datasets["training"][0])
                        if self.datasets["training"] else 0)
        if not cfg.evaluate and self.datasets["training"] and self.writer:
            # run-config stamp file (reference/main.py:333-335)
            n_classes = len(self.datasets["training"][0].classes)
            stamp = os.path.join(
                self.savename, f"train_samples_{n_classes}_{trainsamples}.txt")
            with open(stamp, "w") as f:
                f.write(f"{n_classes}, {trainsamples}\n")
        summary = {}
        for epoch in range(self.start_epoch, cfg.n_epochs):
            print(f"\n{cfg.network.upper()} {cfg.dataset.upper()} "
                  f"LR {self.lr_at(epoch)} BS {self.global_bs} "
                  f"CLIP_LEN {cfg.clip_len} N_CLIPS {cfg.n_clips} "
                  f"OVERLAP {cfg.class_overlap} SAMPLES {trainsamples}")
            t0 = time.time()
            if not cfg.evaluate and self.datasets["training"]:
                if cfg.profile_dir and epoch == self.start_epoch:
                    from zeroshotvideoclassification_tpu_torch.utils.profiler \
                        import device_trace

                    with device_trace(cfg.profile_dir):
                        summary.update(self.train_one_epoch(epoch))
                else:
                    summary.update(self.train_one_epoch(epoch))
            accuracies = []
            for table in self.datasets["testing"]:
                r = self.evaluate(table, epoch)
                accuracies.append(r["accuracy"])
                summary[f"{table.name}_accuracy"] = r["accuracy"]
            mean_acc = float(np.mean(accuracies)) if accuracies else 0.0
            improved = mean_acc > self.best_acc
            # --evaluate is read-only: it writes no checkpoint; the
            # replicas are equal, so process 0 writes the one file
            save_best = improved and not cfg.evaluate
            save_last = bool(cfg.checkpoint_every and not cfg.evaluate
                             and (epoch + 1) % cfg.checkpoint_every == 0)
            if save_best or save_last:
                self.agree_bn_statistics()
            if (save_best or save_last) and self.grid.data_index == 0:
                # the state comes to host numpy here, on this thread (under
                # --tp process 0's model group gathers the head's shards);
                # the writer thread writes it while the next epoch runs
                state = host_state(self.train_step.state)
            save_best, save_last = (save_best and self.writer,
                                    save_last and self.writer)
            if save_best:
                self._ckpt_writer().submit(
                    os.path.join(self.savename, "checkpoint.npz"), state,
                    epoch, mean_acc, cfg.to_json())
            if improved:
                self.best_acc = mean_acc
            if save_last:
                # periodic full state for preemption recovery (--resume
                # auto); the reference's best-only policy loses everything
                # between accuracy improvements
                self._ckpt_writer().submit(
                    os.path.join(self.savename, "last.npz"), state, epoch,
                    self.best_acc, cfg.to_json())
            print("----- Epoch %d done in %.2f min. Best accuracy %.1f"
                  % (epoch, (time.time() - t0) / 60, self.best_acc))
            if cfg.evaluate:
                break
        summary["best_accuracy"] = self.best_acc
        if self._ckpt is not None:
            # the files are complete when run() returns: a later job (or
            # the caller) reads them next
            self._ckpt.close()
            self._ckpt = None
        self.log.close()
        return summary


def build_arg_parser() -> argparse.ArgumentParser:
    p = build_config_parser()
    p.add_argument("--device", default="cuda",
                   help="torch device (cuda, cuda:1, cpu); cuda without a "
                        "GPU is an error")
    return p


def local_world(device) -> int:
    """How many processes a launch of `device` runs here: every visible GPU
    for a plain `cuda` (no index) outside a process group, else 1."""
    device = torch.device(device)
    if group_active() or device.type != "cuda" or device.index is not None:
        return 1
    return max(torch.cuda.device_count(), 1)


def _rank_main(argv, out_dir):
    """One spawned process of a plain launch on several GPUs: the trainer,
    and process 0's summary into out_dir."""
    summary = main(argv)
    if process_index() == 0:
        with open(os.path.join(out_dir, "summary.json"), "w") as f:
            json.dump(summary, f)


def main(argv=None):
    args = build_arg_parser().parse_args(argv)
    # torchrun's processes join their group before anything else
    opened = maybe_initialize(device=args.device)
    try:
        return _main(args, argv)
    finally:
        if opened:
            destroy()


def _main(args, argv):
    config = config_from_namespace(args)
    check_tensor_parallel(config, config.tp)
    if config.steps_per_call > 1:
        check_capturable(args.device)
    n_local = local_world(args.device)
    if n_local > 1:
        # a plain launch on a host with several GPUs uses all of them
        with tempfile.TemporaryDirectory(prefix="zsvc_ranks_") as tmp:
            run_local_ranks(
                _rank_main,
                (sys.argv[1:] if argv is None else list(argv), tmp),
                n_local, f"file://{os.path.join(tmp, 'store')}")
            with open(os.path.join(tmp, "summary.json")) as f:
                return json.load(f)
    rank_device(args.device)
    # the mesh over this launch's processes: a --tp that does not divide
    # them raises here, before the datasets
    make_mesh(config.mesh_shape, config.mesh_axes)
    wv_model = None
    if "synthetic" not in config.dataset:
        from zeroshotvideoclassification_tpu_torch.text import load_word2vec

        wv_model = load_word2vec(config.word2vec_path, config.word2vec_cache)
    datasets = build_datasets(config, wv_model)
    exp = Experiment(config, datasets, device=args.device)
    return exp.run()


if __name__ == "__main__":
    main()
