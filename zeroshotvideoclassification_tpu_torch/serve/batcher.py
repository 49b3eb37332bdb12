"""Micro-batching request queue for the serving front-end.

Copy of zeroshotvideoclassification_tpu/serve/batcher.py (the port keeps
its own host side). The serving forward amortizes with batch (PERF.md has
the port's clips/s per dispatch bucket), so a production endpoint must
coalesce concurrent requests into one device dispatch instead of
dispatching per request. This module is the generic
half: callers submit items and block on a Future; a single worker thread
drains the queue into batches of at most `max_batch`, waiting at most
`max_wait_s` after the first item of a batch arrives (classic
max-batch/max-delay policy), and hands each batch to `process_batch`.

Two-stage pipelining: with `stage2` set, `process_batch` becomes the HOST
stage (decode + pack — GIL-free in the native decoders) and `stage2` the
DEVICE stage (dispatch + fetch + rank). A second worker drains a bounded
hand-off queue, so the host decodes batch N+1 while the device runs batch
N — under saturation the slower of the two stages sets throughput instead
of their sum. Device dispatch stays single-threaded by construction (one
stage-2 worker), which matches the engine's one device thread: the stages
pad to the static shapes of the dispatch ladder internally.
"""

from __future__ import annotations

import collections
import queue
import threading
import time
from concurrent.futures import Future
from typing import Callable, Deque, List, Optional, Sequence


class MicroBatcher:
    def __init__(
        self,
        process_batch: Callable[[Sequence], List],
        max_batch: int = 16,
        max_wait_s: float = 0.01,
        stage2: Optional[Callable] = None,
        pipeline_depth: int = 2,
    ):
        """`process_batch(items) -> results` (same length/order) runs on the
        worker thread; exceptions there fail every future of that batch.
        With `stage2`, `process_batch(items) -> mid` feeds
        `stage2(mid) -> results` on a second worker (see module docstring);
        `pipeline_depth` bounds how many packed batches may wait between the
        stages (backpressure caps host-side lookahead memory)."""
        if max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        if stage2 is not None and pipeline_depth < 1:
            # Queue(maxsize=0) means UNBOUNDED in Python — the opposite of
            # the backpressure this parameter documents; 'no pipelining'
            # is expressed by not passing stage2 (ZeroShotService does so)
            raise ValueError("pipeline_depth must be >= 1 when stage2 is "
                             "set (omit stage2 to disable pipelining)")
        self.process_batch = process_batch
        self.stage2 = stage2
        self.max_batch = max_batch
        self.max_wait_s = max_wait_s
        self._q: "queue.Queue" = queue.Queue()
        self._stop = threading.Event()
        self._accepting = True
        # submitted/completed counters let shutdown(drain=True) wait until
        # every accepted request resolved; completion has two writer threads
        # (stage-1 exception paths + whichever stage finishes), so the pair
        # shares one lock
        self._count_lock = threading.Lock()
        self.n_submitted = 0
        self.n_completed = 0
        self.n_requests = 0
        self.n_batches = 0
        # bounded: an always-on server would otherwise leak one int per batch
        self.batch_sizes: Deque[int] = collections.deque(maxlen=1000)
        self.batch_latency_s: Deque[float] = collections.deque(maxlen=1000)
        self._workers = [threading.Thread(target=self._run, daemon=True)]
        if stage2 is not None:
            self._s2_q: "queue.Queue" = queue.Queue(maxsize=pipeline_depth)
            self._workers.append(
                threading.Thread(target=self._run_stage2, daemon=True))
        for w in self._workers:
            w.start()

    def submit(self, item) -> Future:
        fut: Future = Future()
        # the accepting check and the submitted-counter increment must be
        # atomic: a submit that passed the check but had not yet counted
        # itself would be invisible to shutdown(drain=True)'s wait, so an
        # "accepted" request could be failed instead of drained
        with self._count_lock:
            if self._stop.is_set() or not self._accepting:
                raise RuntimeError("batcher is shut down")
            self.n_submitted += 1
        self._q.put((item, fut, time.monotonic()))
        if self._stop.is_set():
            # shutdown() raced our put: its drain may already have finished,
            # and the worker exits once _stop is set — nothing will ever
            # collect this item, so drain-and-fail here (same semantics as
            # the shutdown drain; whichever side runs last sees the item)
            self._drain_pending()
        return fut

    def __call__(self, item):
        """Blocking convenience: submit + wait."""
        return self.submit(item).result()

    def _collect(self):
        """Block for the first item, then drain up to max_batch within the
        wait window."""
        try:
            first = self._q.get(timeout=0.1)
        except queue.Empty:
            return []
        batch = [first]
        deadline = time.monotonic() + self.max_wait_s
        while len(batch) < self.max_batch:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                # window closed: take only what is already queued
                try:
                    batch.append(self._q.get_nowait())
                    continue
                except queue.Empty:
                    break
            try:
                batch.append(self._q.get(timeout=remaining))
            except queue.Empty:
                break
        return batch

    def _mark_done(self, n: int):
        with self._count_lock:
            self.n_completed += n

    def _finish(self, futures, submitted, results):
        if len(results) != len(futures):
            raise RuntimeError(f"got {len(results)} results for "
                               f"{len(futures)} items")
        done = time.monotonic()
        for f, r, t in zip(futures, results, submitted):
            self.batch_latency_s.append(done - t)
            f.set_result(r)
        self._mark_done(len(futures))

    def _run(self):
        while not self._stop.is_set():
            batch = self._collect()
            if not batch:
                continue
            items = [it for it, _, _ in batch]
            futures = [f for _, f, _ in batch]
            submitted = [t for _, _, t in batch]
            self.n_requests += len(batch)
            self.n_batches += 1
            self.batch_sizes.append(len(batch))
            try:
                r1 = self.process_batch(items)
                if self.stage2 is None:
                    self._finish(futures, submitted, r1)
                    continue
            except BaseException as e:
                for f in futures:
                    if not f.done():
                        f.set_exception(e)
                self._mark_done(len(futures))
                continue
            # hand off to the device stage; a full queue is backpressure
            # (bounded host lookahead), re-checked against shutdown
            while True:
                try:
                    self._s2_q.put((r1, futures, submitted), timeout=0.5)
                    # shutdown may have finished its drain while this stage
                    # was packing (a long decode outlives the join timeout):
                    # with stage 2 already gone, nothing would ever collect
                    # the batch — re-check and drain, same as submit()
                    if self._stop.is_set():
                        self._drain_pending()
                    break
                except queue.Full:
                    if self._stop.is_set():
                        for f in futures:
                            if not f.done():
                                f.set_exception(
                                    RuntimeError("batcher shut down"))
                        self._mark_done(len(futures))
                        break

    def _run_stage2(self):
        while True:
            try:
                mid, futures, submitted = self._s2_q.get(timeout=0.1)
            except queue.Empty:
                if self._stop.is_set():
                    return
                continue
            try:
                self._finish(futures, submitted, self.stage2(mid))
            except BaseException as e:
                for f in futures:
                    if not f.done():
                        f.set_exception(e)
                self._mark_done(len(futures))

    def _drain_pending(self):
        """Fail every future still sitting in the queues (post-stop only)."""
        while True:
            try:
                _, fut, _ = self._q.get_nowait()
            except queue.Empty:
                break
            if not fut.done():
                fut.set_exception(RuntimeError("batcher shut down"))
            self._mark_done(1)
        if self.stage2 is not None:
            while True:
                try:
                    _, futures, _ = self._s2_q.get_nowait()
                except queue.Empty:
                    break
                for fut in futures:
                    if not fut.done():
                        fut.set_exception(RuntimeError("batcher shut down"))
                self._mark_done(len(futures))

    def shutdown(self, timeout: float = 5.0, drain: bool = False,
                 drain_timeout: float = 30.0):
        """Stop the workers and fail any still-pending futures: items queued
        but never collected would otherwise block their request threads for
        the caller's full result timeout.

        drain=True is the graceful variant (SIGTERM handling in
        cli/serve.py): stop ACCEPTING first, let every already-accepted
        request resolve normally (bounded by drain_timeout), THEN stop the
        workers — a rolling restart should not fail requests it already
        took."""
        if drain:
            with self._count_lock:  # pairs with submit()'s atomic check
                self._accepting = False
            deadline = time.monotonic() + drain_timeout
            while time.monotonic() < deadline:
                with self._count_lock:
                    done = self.n_completed >= self.n_submitted
                if done:
                    break
                time.sleep(0.02)
        self._stop.set()
        for w in self._workers:
            w.join(timeout=timeout)
        self._drain_pending()

    @staticmethod
    def _percentile(sorted_vals: List[float], q: float) -> float:
        if not sorted_vals:
            return 0.0
        i = min(len(sorted_vals) - 1, int(round(q * (len(sorted_vals) - 1))))
        return sorted_vals[i]

    def stats(self) -> dict:
        sizes = list(self.batch_sizes)
        lat = sorted(self.batch_latency_s)
        return {
            "requests": self.n_requests,
            "batches": self.n_batches,
            "mean_batch": (sum(sizes) / len(sizes)) if sizes else 0.0,
            "max_batch_seen": max(sizes) if sizes else 0,
            # submit -> result, over the last <=1000 completed requests
            "latency_p50_ms": round(self._percentile(lat, 0.50) * 1e3, 3),
            "latency_p95_ms": round(self._percentile(lat, 0.95) * 1e3, 3),
            "latency_max_ms": round(lat[-1] * 1e3, 3) if lat else 0.0,
        }
