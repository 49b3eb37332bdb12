"""Inference engine: checkpoint + class names -> batched zero-shot scoring on
every local GPU, one replica each.

Counterpart of zeroshotvideoclassification_tpu/serve/engine.py with the same
public surface, so the MicroBatcher and HTTP server (serve/batcher.py,
serve/server.py, copies of the JAX package's) drive it as they are: the
dispatch-shape ladder {8, 16, 32, 64, max_batch}, each bucket rounded up to
a multiple of the replica count, pack_paths (host decode + pack, on the
batcher's first stage), dispatch_packed / classify_packed (device work, on
its second stage), classify, warmup, a strict hot-swap reload, stats and
close. Each dispatch pads to the smallest bucket that fits, with zero-weight
rows (the pipeline's broken-sample convention).

Devices (cli/infer.resolve_devices): a plain `cuda` is every visible GPU,
as the JAX engine meshes every local chip on 'data'; `cuda:N` one GPU,
`cpu` one CPU replica, or a list of devices (an entry may repeat). The
engine holds one model per device. A dispatch splits the bucket's rows
into n_shards contiguous slices, replica i taking rows [i b/n, (i+1) b/n)
as JAX's 'data' sharding gives device i: pinned H2D copy of its slice, K1
(the fused transform), the model (cuDNN convs + K2 epilogues + float32
head); the rows come back in device order, and the cosine ranking runs on
the first device. Each replica's device work runs on a thread of its own
whose CUDA device is the replica's: cuDNN's handles and its table of timed
conv algorithms are per-thread in PyTorch, so warmup() prepares, for every
bucket's slice shape, the very thread that serves it (served from the
batcher's own thread, the first live request took ~2 s longer than the
next on an H100). A replica that fails raises; no other replica serves in
its place.
"""

from __future__ import annotations

import concurrent.futures as cf
import dataclasses
import os
import threading
from typing import List, Optional, Sequence

import numpy as np
import torch

from zeroshotvideoclassification_tpu_torch.cli.infer import (
    build_scoring_state,
    load_model,
    rank_results,
    resolve_devices,
)
from zeroshotvideoclassification_tpu_torch.config import (
    Config,
    transform_dtype,
)
from zeroshotvideoclassification_tpu_torch.data.pipeline import (
    device_batch,
    host_batch,
)
from zeroshotvideoclassification_tpu_torch.ops.cdist import cosine_distances
from zeroshotvideoclassification_tpu_torch.utils import profiler


class InferenceEngine:
    def __init__(
        self,
        class_names: Sequence[str],
        class_embed: np.ndarray,
        network: str = "r2plus1d_18",
        head: str = "mlp",
        weights: Optional[str] = None,
        n_clips: int = 4,
        clip_len: int = 16,
        size: int = 112,
        max_batch: int = 128,
        compute_dtype: str = "bfloat16",
        top_k: int = 5,
        decode_scale: int = 1,
        device="cuda",
        clip_pool: str = "feature",
    ):
        self.devices = resolve_devices(device)
        self.device = self.devices[0]  # where the ranking runs
        self.n_shards = len(self.devices)
        self.class_names = list(class_names)
        self.class_embed = np.asarray(class_embed, np.float32)
        self._class_embed_dev = torch.from_numpy(self.class_embed).to(
            self.device)
        self.top_k = min(top_k, len(self.class_names))
        self.max_batch = max_batch

        def _fit(b):  # bucket shapes tile the replicas (JAX's _fit)
            return -(-b // self.n_shards) * self.n_shards

        # smallest bucket >= n wins: lone requests avoid the large shape's
        # padding, saturated batches still run at max_batch
        self.batch_buckets = sorted(
            {_fit(b) for b in (8, 16, 32, 64) if b < max_batch}
            | {_fit(max_batch)})
        self.bucket_dispatches = {b: 0 for b in self.batch_buckets}
        # network, head and clip_pool pick the model (models.get_network)
        self.config = Config(network=network, head=head, bs=max_batch,
                             clip_len=clip_len, size=size, n_clips=n_clips,
                             compute_dtype=compute_dtype,
                             decode_scale=decode_scale, clip_pool=clip_pool)
        # process-wide settings (TF32 off, cuDNN timing) and the first
        # device's model; then one model for each other device
        model, self.eval_step = build_scoring_state(self.config, weights,
                                                    self.device)
        # ONE attribute holds (weights_path, a model per replica) so a
        # concurrent reload() swap is atomic: a dispatch that read the
        # tuple finishes wholly on the old weights, on every replica
        self._scoring = (weights, self._replicas({self.device: model},
                                                 weights))
        # one decode pool for the engine's life (pack_paths builds a
        # single-batch HostPipeline per request)
        self._decode_pool = cf.ThreadPoolExecutor(
            max_workers=self.config.decode_workers or (os.cpu_count() or 1))
        # every replica's device work runs on its own thread (module
        # docstring)
        self._device_threads = [
            cf.ThreadPoolExecutor(max_workers=1,
                                  thread_name_prefix=f"zsvc-device-{i}",
                                  initializer=_bind, initargs=(d,))
            for i, d in enumerate(self.devices)]
        self._stats_lock = threading.Lock()
        self._warmup_active = False
        self.n_dispatches = 0
        self.device_seconds = 0.0
        # the warm-ups' share of the span registry: name -> [count, s]
        self._warmup_spans = {}

    def _replicas(self, built, weights):
        """One model per replica: a model per distinct device (those in
        `built` already made), each built and loaded strictly by
        cli/infer.load_model; replicas on one device share its model."""
        for d in self.devices:
            if d not in built:
                built[d] = load_model(self.config, weights, d)[0]
        return tuple(built[d] for d in self.devices)

    @property
    def weights_path(self):
        return self._scoring[0]

    @property
    def models(self):
        """The replicas' models, in device order."""
        return self._scoring[1]

    @property
    def model(self):
        return self._scoring[1][0]

    def close(self):
        """Shut down the decode pool and the device threads (non-daemon
        threads). Idempotent; the engine must not be used afterwards."""
        self._decode_pool.shutdown(wait=True, cancel_futures=True)
        for th in self._device_threads:
            th.shutdown(wait=True, cancel_futures=True)

    def _on_device_thread(self, fn, *args):
        return self._device_threads[0].submit(fn, *args).result()

    # ------------------------------------------------------------- embed ----
    def pack_paths(self, paths: Sequence[str]):
        """HOST half: decode + pack ONE padded host batch at the smallest
        ladder shape that fits (no device work)."""
        n = len(paths)
        if n == 0:
            return {"paths": [], "n": 0, "bucket": None, "hb": None}
        if n > self.max_batch:
            raise ValueError(f"{n} paths > max_batch {self.max_batch}")
        bucket = next(b for b in self.batch_buckets if n <= b)
        hb = host_batch(paths, self.config, bucket, self.class_names,
                        self.class_embed, pool=self._decode_pool)
        return {"paths": list(paths), "n": n, "bucket": bucket, "hb": hb}

    def dispatch_packed(self, packed):
        """DEVICE half: H2D + transform + forward, each replica on its
        slice of the rows -> (emb [n, 300], ok [n])."""
        n = packed["n"]
        if n == 0:
            return (np.zeros((0, self.class_embed.shape[1]), np.float32),
                    np.zeros((0,), bool))
        _, models = self._scoring  # one read: one checkpoint per dispatch
        hb, per = packed["hb"], packed["bucket"] // self.n_shards
        with profiler.span("serve.dispatch") as dispatch:
            futures = [th.submit(self._forward, m,
                                 _rows(hb, i * per, (i + 1) * per), d)
                       for i, (th, m, d) in enumerate(zip(
                           self._device_threads, models, self.devices))]
            cf.wait(futures)  # every replica ends before one's error raises
            out = np.concatenate([f.result() for f in futures])
        if not self._warmup_active:  # warmup dispatches stay out of /stats
            with self._stats_lock:
                self.device_seconds += dispatch.seconds
                self.n_dispatches += 1
                self.bucket_dispatches[packed["bucket"]] += 1
        # decode success is a host fact (weight 0 = failed or padding)
        w = np.asarray(hb.weight)
        return out[:n], w[:n] > 0

    def _forward(self, model, hb, device) -> np.ndarray:
        with profiler.span("serve.replica"):
            batch = device_batch(hb, self.config.n_clips,
                                 self.config.clip_len,
                                 transform_dtype(self.config), device)
            return self.eval_step(model, batch["x"]).float().cpu().numpy()

    def embed_paths(self, paths: Sequence[str]):
        """paths (<= max_batch, loader kinds freely mixed) ->
        (emb [n, 300], ok [n])."""
        return self.dispatch_packed(self.pack_paths(paths))

    # ------------------------------------------------------------ reload ----
    def reload(self, weights: str) -> dict:
        """Hot-swap the model from a JAX npz checkpoint without restarting.

        STRICT loads only (train/checkpoint.py): a live endpoint must never
        end up serving a partly or fully random model. The new models (one
        per device) are built and loaded beside the old ones, then swapped
        in with one assignment; an in-flight dispatch finishes on the old
        ones."""
        if not weights or weights == "none":
            raise ValueError(
                "reload needs a checkpoint path (refusing to swap the "
                "serving model to random-init weights)")
        model, meta = load_model(self.config, weights, self.device)
        self._scoring = (weights, self._replicas({self.device: model},
                                                 weights))
        return {"reloaded": weights,
                "epoch": meta.get("epoch"),
                "accuracy": meta.get("accuracy")}

    # ------------------------------------------------------------ warmup ----
    def warmup(self):
        """Run every bucket of the ladder once before serving: the first
        call builds (or loads) the CUDA kernels, and each bucket's first
        forward times cuDNN's conv algorithms for its slice shape (see
        cli/infer.build_scoring_state) on every replica's device thread, so
        no live request waits on either. Nonexistent paths ride the
        decode-failure (weight-0) convention; warmup dispatches are not
        counted in stats(), nor their spans in span_stats()."""
        self._warmup_active = True
        before = profiler.registry().totals()
        try:
            for b in self.batch_buckets:
                # a bucket can exceed max_batch (the ladder rounds up to
                # tile the replicas): cap the fill; smallest-fit still
                # selects bucket b
                self.classify(["/nonexistent/__warmup__.npy"]
                              * min(b, self.max_batch))
        finally:
            after = profiler.registry().totals()
            with self._stats_lock:
                for name, (count, seconds, _) in after.items():
                    c0, s0, _ = before.get(name, (0, 0.0, 0.0))
                    w = self._warmup_spans.setdefault(name, [0, 0.0])
                    w[0] += count - c0
                    w[1] += seconds - s0
            self._warmup_active = False

    # ----------------------------------------------------------- classify ---
    def classify_packed(self, packed) -> List[dict]:
        """DEVICE half of classify (stage 2 in the pipelined batcher)."""
        emb, ok = self.dispatch_packed(packed)
        return self._rank(packed["paths"], emb, ok)

    def classify(self, paths: Sequence[str]) -> List[dict]:
        """-> one result dict per path (cli/infer.py response schema)."""
        emb, ok = self.embed_paths(paths)
        return self._rank(paths, emb, ok)

    def _rank(self, paths, emb, ok) -> List[dict]:
        if emb.shape[0] == 0:
            return []
        dist = self._on_device_thread(self._distances, emb)
        return rank_results(paths, dist, ok, self.class_names, self.top_k)

    def _distances(self, emb: np.ndarray) -> np.ndarray:
        return cosine_distances(torch.from_numpy(emb).to(self.device),
                                self._class_embed_dev).cpu().numpy()

    def span_stats(self) -> dict:
        """The process's spans (utils/profiler.py) without this engine's
        warm-ups: name -> {count, total_ms}."""
        totals = profiler.registry().totals()
        with self._stats_lock:
            warm = {k: tuple(v) for k, v in self._warmup_spans.items()}
        out = {}
        for name, (count, seconds, _) in sorted(totals.items()):
            c0, s0 = warm.get(name, (0, 0.0))
            if count > c0:
                out[name] = {"count": count - c0,
                             "total_ms": round(1e3 * (seconds - s0), 3)}
        return out

    def stats(self) -> dict:
        with self._stats_lock:
            return {
                "dispatches": self.n_dispatches,
                "device_seconds": round(self.device_seconds, 3),
                "max_batch": self.max_batch,
                "data_shards": self.n_shards,
                "batch_buckets": {str(b): c
                                  for b, c in self.bucket_dispatches.items()},
                "classes": len(self.class_names),
                "weights": self.weights_path,
                "device": ",".join(str(d) for d in self.devices),
            }


def _bind(device: torch.device) -> None:
    """A replica thread's initializer: its CUDA device becomes the thread's
    current one, so the allocator, the current stream and cuDNN's
    per-thread handles are the replica's."""
    if device.type == "cuda":
        torch.cuda.set_device(device)


def _rows(hb, start: int, stop: int):
    """Rows [start, stop) of a host batch (every per-sample array)."""
    per_sample = {f.name: getattr(hb, f.name)[start:stop]
                  for f in dataclasses.fields(hb)
                  if isinstance(getattr(hb, f.name), np.ndarray)}
    return dataclasses.replace(hb, **per_sample)
