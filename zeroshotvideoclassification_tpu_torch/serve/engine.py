"""Inference engine: checkpoint + class names -> batched zero-shot scoring on
one GPU.

Counterpart of zeroshotvideoclassification_tpu/serve/engine.py with the same
public surface, so the MicroBatcher and HTTP server (serve/batcher.py,
serve/server.py, copies of the JAX package's) drive it as they are: the
dispatch-shape ladder {8, 16, 32, 64, max_batch}, pack_paths (host decode +
pack, on the
batcher's first stage), dispatch_packed / classify_packed (device work, on
its second stage), classify, warmup, a strict hot-swap reload, stats and
close. Each dispatch pads to the smallest bucket that fits, with zero-weight
rows (the pipeline's broken-sample convention).

Device work per dispatch: pinned H2D copy of the canvas, K1 (the fused
transform), the model (cuDNN convs + K2 epilogues + float32 head), then the
cosine ranking. All of it runs on ONE engine-owned thread, whichever thread
calls: cuDNN's handles and its table of timed conv algorithms are
per-thread in PyTorch, so warmup() prepares the very thread that serves
(served from the batcher's own thread, the first live request took ~2 s
longer than the next on an H100). One device only; several GPUs are later
work.
"""

from __future__ import annotations

import concurrent.futures as cf
import os
import threading
import time
from typing import List, Optional, Sequence

import numpy as np
import torch

from zeroshotvideoclassification_tpu_torch.cli.infer import (
    build_scoring_state,
    load_model,
    rank_results,
    resolve_device,
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
        self.device = resolve_device(device)
        self.class_names = list(class_names)
        self.class_embed = np.asarray(class_embed, np.float32)
        self._class_embed_dev = torch.from_numpy(self.class_embed).to(
            self.device)
        self.top_k = min(top_k, len(self.class_names))
        self.max_batch = max_batch
        self.n_shards = 1
        # smallest bucket >= n wins: lone requests avoid the large shape's
        # padding, saturated batches still run at max_batch
        self.batch_buckets = sorted(
            {b for b in (8, 16, 32, 64) if b < max_batch} | {max_batch})
        self.bucket_dispatches = {b: 0 for b in self.batch_buckets}
        # network, head and clip_pool pick the model (models.get_network)
        self.config = Config(network=network, head=head, bs=max_batch,
                             clip_len=clip_len, size=size, n_clips=n_clips,
                             compute_dtype=compute_dtype,
                             decode_scale=decode_scale, clip_pool=clip_pool)
        model, self.eval_step = build_scoring_state(self.config, weights,
                                                    self.device)
        # ONE attribute holds (weights_path, model) so a concurrent reload()
        # swap is atomic: a dispatch that read the tuple finishes wholly on
        # the old weights
        self._scoring = (weights, model)
        # one decode pool for the engine's life (pack_paths builds a
        # single-batch HostPipeline per request)
        self._decode_pool = cf.ThreadPoolExecutor(
            max_workers=self.config.decode_workers or (os.cpu_count() or 1))
        # every device call runs here (module docstring)
        self._device_thread = cf.ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="zsvc-device")
        self._stats_lock = threading.Lock()
        self._warmup_active = False
        self.n_dispatches = 0
        self.device_seconds = 0.0

    @property
    def weights_path(self):
        return self._scoring[0]

    @property
    def model(self):
        return self._scoring[1]

    def close(self):
        """Shut down the decode pool and the device thread (non-daemon
        threads). Idempotent; the engine must not be used afterwards."""
        self._decode_pool.shutdown(wait=True, cancel_futures=True)
        self._device_thread.shutdown(wait=True, cancel_futures=True)

    def _on_device_thread(self, fn, *args):
        return self._device_thread.submit(fn, *args).result()

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
        """DEVICE half: H2D + transform + forward -> (emb [n, 300], ok [n])."""
        n = packed["n"]
        if n == 0:
            return (np.zeros((0, self.class_embed.shape[1]), np.float32),
                    np.zeros((0,), bool))
        _, model = self._scoring  # one read: one checkpoint per dispatch
        t0 = time.perf_counter()
        out = self._on_device_thread(self._forward, model, packed["hb"])
        if not self._warmup_active:  # warmup dispatches stay out of /stats
            with self._stats_lock:
                self.device_seconds += time.perf_counter() - t0
                self.n_dispatches += 1
                self.bucket_dispatches[packed["bucket"]] += 1
        # decode success is a host fact (weight 0 = failed or padding)
        w = np.asarray(packed["hb"].weight)
        return out[:n], w[:n] > 0

    def _forward(self, model, hb) -> np.ndarray:
        batch = device_batch(hb, self.config.n_clips, self.config.clip_len,
                             transform_dtype(self.config), self.device)
        return self.eval_step(model, batch["x"]).float().cpu().numpy()

    def embed_paths(self, paths: Sequence[str]):
        """paths (<= max_batch, loader kinds freely mixed) ->
        (emb [n, 300], ok [n])."""
        return self.dispatch_packed(self.pack_paths(paths))

    # ------------------------------------------------------------ reload ----
    def reload(self, weights: str) -> dict:
        """Hot-swap the model from a JAX npz checkpoint without restarting.

        STRICT loads only (train/checkpoint.py): a live endpoint must never
        end up serving a partly or fully random model. The new model is
        built and loaded beside the old one, then swapped in with one
        assignment; an in-flight dispatch finishes on the old one."""
        if not weights or weights == "none":
            raise ValueError(
                "reload needs a checkpoint path (refusing to swap the "
                "serving model to random-init weights)")
        model, meta = load_model(self.config, weights, self.device)
        self._scoring = (weights, model)
        return {"reloaded": weights,
                "epoch": meta.get("epoch"),
                "accuracy": meta.get("accuracy")}

    # ------------------------------------------------------------ warmup ----
    def warmup(self):
        """Run every bucket of the ladder once before serving: the first
        call builds (or loads) the CUDA kernels, and each bucket's first
        forward times cuDNN's conv algorithms for its shapes (see
        cli/infer.build_scoring_state) on the engine's device thread, so no
        live request waits on either. Nonexistent paths ride the
        decode-failure (weight-0) convention; warmup dispatches are not
        counted in stats."""
        self._warmup_active = True
        try:
            for b in self.batch_buckets:
                self.classify(["/nonexistent/__warmup__.npy"] * b)
        finally:
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
                "device": str(self.device),
            }
