"""Training and evaluation entry point with reference CLI parity, on one
GPU or on several processes with one GPU each.

Counterpart of zeroshotvideoclassification_tpu/cli/main.py: build the
datasets, then per epoch set the learning rate from the MultiStepLR
schedule, iterate the host pipeline (seeded with seed + epoch,
sample-capped like reference/main.py:208), move each host batch to the
device (pinned H2D + the transform: K1 for videos, the antialiased
transform or K4 for still images), take one train step (train/step.py: K2
forward and backward in every epilogue, guarded Adam), log every
`log_every` steps; then evaluate every test table zero-shot (full set +
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
(seed << 16) + epoch, plus rank << 48 on the processes of a group (each
draws its own shard's masks).

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

The flags are the JAX trainer's (config.build_arg_parser, the same Config)
plus --device, which defaults to cuda (cuda:LOCAL_RANK under a process
group); asking for cuda without a GPU raises. What the port does not do
yet raises NotImplementedError, naming its ROADMAP item, before any
dataset is built: --tp > 1 (P7b), and --steps_per_call > 1 /
--save_samples / --debug_nans (P11).
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
from zeroshotvideoclassification_tpu_torch.models.layers import init_weights
from zeroshotvideoclassification_tpu_torch.parallel import (
    agree_from_process_zero,
    make_mesh,
    maybe_initialize,
    process_count,
    process_index,
    shard_table,
    sync_processes,
)
from zeroshotvideoclassification_tpu_torch.parallel.multihost import (
    group_active,
    local_rank,
    run_local_ranks,
)
from zeroshotvideoclassification_tpu_torch.train import (
    eval_step,
    host_state,
    load_checkpoint,
    make_optimizer,
    make_train_step,
    multistep_lr,
    read_meta,
    set_lr,
    warm_start,
)
from zeroshotvideoclassification_tpu_torch.utils.logging import (
    MetricsLogger,
    Timer,
    colored,
)


def check_ported(config: Config) -> None:
    """Raise NotImplementedError for every request the port cannot honour
    yet, naming the ROADMAP item that will."""
    asked = [
        (config.tp > 1, "--tp > 1", "P7b"),
        (config.steps_per_call > 1, "--steps_per_call > 1", "P11"),
        (config.save_samples, "--save_samples", "P11"),
        (config.debug_nans, "--debug_nans", "P11"),
    ]
    for wanted, what, item in asked:
        if wanted:
            raise NotImplementedError(
                f"{what} is not ported yet (ROADMAP {item})")


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
    the devices and split evenly across processes (in the port both are
    the number of processes: one device each), then capped at the table
    size (same rounding) so tiny test sets don't dispatch mostly padding.

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
        check_ported(config)
        self.config = config
        self.datasets = datasets
        self.device = rank_device(device)
        # full float32 where float32 is asked for, and cuDNN timing its
        # algorithms per conv shape, as cli/infer.build_scoring_state
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.benchmark = True
        self.rank, self.world = process_index(), process_count()
        self.n_data = make_mesh(config.mesh_shape, config.mesh_axes,
                                self.world).get("data", 1)
        # reference: bs * n_gpus (main.py:61-63); each process feeds its
        # lockstep share of the global batch
        self.global_bs = config.bs * self.n_data
        if self.global_bs % self.world:
            raise ValueError(
                f"global batch {self.global_bs} not divisible by "
                f"process_count {self.world}; adjust --bs")
        self.local_bs = self.global_bs // self.world
        train_tables = datasets.get("training") or []
        self.train_bs, self.train_local_bs = self.global_bs, self.local_bs
        if (train_tables and train_tables[0].loader == "image"
                and config.class_total != 0):
            # checked here, at construction, not at the first epoch
            self.train_bs, self.train_local_bs = self._image_train_batch()
        self.model = get_network(config)
        init_weights(self.model, torch.Generator().manual_seed(config.seed))
        self.model = self.model.to(device=self.device,
                                   memory_format=torch.channels_last_3d)
        self.optimizer = make_optimizer(self.model.parameters(), config.lr)
        self.lr_at = multistep_lr(config.lr, config.n_epochs)
        self.dtype = torch_dtype(config.compute_dtype)
        self.train_step = make_train_step(self.model, self.optimizer,
                                          compute_dtype=self.dtype)
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
        # dropout's masks are drawn where the model is; each process draws
        # its own shard's, as the JAX package draws one over the global batch
        rng = torch.Generator(self.device).manual_seed(
            (cfg.seed << 16) + epoch + (self.rank << 48))
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

        def maybe_log():
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

        while True:
            with batch_t:
                host = next(it, None)
            if host is None:
                break
            if i == 0:
                # the first step's collectives start together
                sync_processes(f"train_dispatch_{epoch}")
            with model_t:
                batch = device_batch(host, table.n_clips, cfg.clip_len,
                                     transform_dtype(cfg), self.device)
                metrics = self.train_step(
                    batch["x"], batch["z"], batch["label"], batch["weight"],
                    class_embed, rng)
                losses.append(metrics["loss"])
                accs.append(metrics["train_accuracy"])
            maybe_log()
            i += 1
            if i * global_bs > cfg.epoch_sample_cap:  # reference/main.py:208
                break
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

    def _image_train_batch(self):
        """(global, local) of the halved SUN image-train batch.

        The reference halves the image-train batch (dataset.py:26:
        `opt.bs // 2 if ... 'image' in opt.dataset ...`) — each SUN sample
        inflates to n_clips*clip_len synthetic frames, so memory per sample
        doubles vs a video clip; halved per device. The halved global batch
        must split evenly across the processes."""
        global_bs = max(self.config.bs // 2, 1) * self.n_data
        if global_bs % self.world:
            raise ValueError(
                f"halved image-train global batch {global_bs} not "
                f"divisible by process_count {self.world}; adjust --bs")
        return global_bs, global_bs // self.world

    # -------------------------------------------------------------- eval ----
    def evaluate(self, table: VideoTable, epoch: int) -> Dict[str, float]:
        cfg = self.config
        eval_bs = eval_batch_size(self.global_bs, table.n_clips, self.n_data,
                                  self.world, len(table),
                                  cfg.eval_clip_budget)
        pipe = HostPipeline(shard_table(table), cfg, eval_bs // self.world,
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
            save_best = improved and not cfg.evaluate and self.writer
            save_last = bool(cfg.checkpoint_every and not cfg.evaluate
                             and (epoch + 1) % cfg.checkpoint_every == 0
                             and self.writer)
            if save_best or save_last:
                # the state comes to host numpy here, on this thread; the
                # writer thread writes it while the next epoch runs
                state = host_state(self.train_step.state)
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
            torch.distributed.destroy_process_group()


def _main(args, argv):
    config = config_from_namespace(args)
    check_ported(config)
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
    wv_model = None
    if "synthetic" not in config.dataset:
        from zeroshotvideoclassification_tpu_torch.text import load_word2vec

        wv_model = load_word2vec(config.word2vec_path, config.word2vec_cache)
    datasets = build_datasets(config, wv_model)
    exp = Experiment(config, datasets, device=args.device)
    return exp.run()


if __name__ == "__main__":
    main()
