"""Serve cells: the whole served path. serve/server.start_server over an
InferenceEngine with the serving CLI's defaults (every visible card, bf16,
max_batch, a 10 ms window, a two-stage pipeline), its model holding the
seeded weights, in front of JPEG frame directories made from the seed.

Set-up makes the videos (under TMPDIR), builds and warms the engine (its
every bucket), starts the server and sends a few requests ahead of the
window. The window is an open loop in a process of its own
(yardstick/loadgen.py): Poisson arrivals at the cell's rate for
--seconds, one video a request, each timed from when it was due. Once
every reply is in, a sample of the requests drawn from the seed (the
video with the most frames among them) is scored again by the plain
reference.
"""

from __future__ import annotations

import gc
import json
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

from benchmark.drivers.train import Record, load_params
from benchmark.reference import serve as reference
from benchmark.reference.models import Net
from benchmark.yardstick import checks, traffic, videos, weights
from benchmark.yardstick.tracing import Recorder


def _percentile(values, q: float) -> float:
    """The q-quantile of `values` by the nearest rank."""
    v = sorted(values)
    return v[min(len(v) - 1, max(0, int(np.ceil(q * len(v))) - 1))]


def schedule(tr: dict, seconds: int, n_videos: int, seed: int):
    """[(offset_s, video index)]: rate x seconds requests whose gaps are
    the exponential distribution's quantiles at tr["rate"] (a Poisson
    process's gaps) and whose videos are every video in turn, both in an
    order drawn from the seed: every seed offers the same arrivals and the
    same videos, in another order."""
    rng = np.random.default_rng(weights.subseed(seed, "arrivals"))
    n = int(round(tr["rate"] * seconds))
    gaps = -np.log1p(-(np.arange(n) + 0.5) / n) / tr["rate"]
    times = np.cumsum(rng.permutation(gaps))
    which = rng.permutation(np.arange(n) % n_videos)
    return [(float(t), int(v)) for t, v in zip(times, which)]


class Timed:
    """Times one of the engine's halves a call, in videos: its seconds and
    videos, and a span of its own in the trace."""

    def __init__(self, fn, rec: Recorder, name: str, count):
        self.fn, self.rec, self.name, self.count = fn, rec, name, count
        self.lock = threading.Lock()
        self.seconds = 0.0
        self.videos = 0

    def __call__(self, arg):
        t0 = time.perf_counter()
        with self.rec.span(self.name):
            out = self.fn(arg)
        with self.lock:
            self.seconds += time.perf_counter() - t0
            self.videos += self.count(arg)
        return out


def run(ctx, rates=None) -> dict:
    """One run of the cell; with `rates`, one window at each rate after one
    set-up, and their outcomes instead (the sweep for the knee; no
    reference)."""
    from zeroshotvideoclassification_tpu_torch.data import decode
    from zeroshotvideoclassification_tpu_torch.serve.engine import (
        InferenceEngine,
    )
    from zeroshotvideoclassification_tpu_torch.serve.server import (
        start_server,
    )

    cfg, tr = ctx.config, ctx.cell["traffic_params"]
    device = torch.device("cuda", 0) if ctx.device == "cuda" else \
        torch.device(ctx.device)
    rec = Recorder(ctx.trace)
    notes = []
    net = Net(cfg["network"], cfg["clip_len"], cfg["size"], ctx.root)
    params = weights.make(net, ctx.seed, device)
    weights.calibrate(net, params, ctx.seed, tr["calibration_clips"], device)
    names = [f"class_{i:03d}" for i in range(tr["classes"])]
    embed = traffic.class_embeddings(tr["classes"], ctx.seed)
    root = tempfile.mkdtemp(prefix="portbench_videos_")
    engine = server = service = None
    try:
        t0 = time.time()
        paths, frames, frame_bytes = videos.make(
            root, tr["videos"], tr["frames"], tr["frame_hw"],
            tr["jpeg_quality"], ctx.seed, threads=os.cpu_count() or 1)
        t1 = time.time()
        engine = InferenceEngine(
            names, embed, network=cfg["network"], head=cfg["head"],
            n_clips=tr["n_clips"], clip_len=cfg["clip_len"],
            size=cfg["size"], max_batch=tr["max_batch"],
            compute_dtype=cfg["compute_dtype"], device=ctx.device)
        seen = set()
        for m in engine.models:
            if id(m) not in seen:
                seen.add(id(m))
                load_params(m, params)
        t2 = time.time()
        engine.warmup()
        t3 = time.time()
        decoder = "native libjpeg" if decode._get_native() else "cv2"
        notes.append(f"videos: {len(paths)} JPEG frame directories, "
                     f"{min(frames)}-{max(frames)} frames of "
                     f"{tr['frame_hw'][1]}x{tr['frame_hw'][0]}, "
                     f"{frame_bytes:.1f} bytes a frame on average; "
                     f"decoder: {decoder}")
        # before start_server, which binds the batcher's two stages
        timer = Timed(engine.pack_paths, rec, "pack", len)
        engine.pack_paths = timer
        engine.classify_packed = Timed(engine.classify_packed, rec,
                                       "dispatch", lambda p: p["n"])
        server, service = start_server(
            engine, port=0, max_wait_s=tr["max_wait_s"],
            pipeline_depth=tr["pipeline_depth"])
        url = f"http://127.0.0.1:{server.server_address[1]}"
        for p in paths[:tr["warm_requests"]]:
            _post_ok(url, p)
        notes.append(f"set-up: videos {t1 - t0:.1f} s, engine {t2 - t1:.1f}"
                     f" s, its warm-up {t3 - t2:.1f} s, warm requests "
                     f"{time.time() - t3:.1f} s")
        if rates is not None:
            return {"sweep": [_outcome(*_offer(
                ctx, dict(tr, rate=r), url, paths, root, service, timer,
                Recorder(False), f"{k}"), ctx.seconds)
                for k, r in enumerate(rates)], "notes": notes}
        results, counters, t_window, arrivals = _offer(
            ctx, tr, url, paths, root, service, timer, rec, "")
        peak = (torch.cuda.max_memory_allocated(device)
                if device.type == "cuda" else 0)
        server.shutdown()
        server.server_close()
        service.close()
        engine.close()
        server = service = engine = None
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
        # the reference, once the program's state is gone
        out = _outcome(results, counters, t_window, arrivals, ctx.seconds)
        t4 = time.time()
        numbers = _compare(net, params, results, out["ok"], arrivals, paths,
                           frames, embed, names, tr, ctx.seed, device)
    finally:
        if server is not None:
            server.shutdown()
            server.server_close()
        if service is not None:
            service.close()
        if engine is not None:
            engine.close()
        shutil.rmtree(root, ignore_errors=True)
    notes.append(f"reference {time.time() - t4:.1f} s")
    notes.append(f"load: {len(results)} requests at {tr['rate']}/s "
                 f"offered; the generator sent its latest "
                 f"{out['late_ms']:.1f} ms after it was due; "
                 f"{out['failed']} failed; latency p50 {out['p50_ms']:.1f} "
                 f"ms, p95 {out['p95_ms']:.1f} ms")
    record = Record(root=ctx.root, cfg=cfg, cell=ctx.cell, chips=ctx.chips,
                    steps=len(results), window_s=rec.window_s,
                    seconds=dict(rec.seconds), trace=rec.trace,
                    counters=counters)
    return {"e2e": {"request_p50_ms": out["p50_ms"],
                    "serve_videos_per_s": out["served_per_s"],
                    "setup_s": t_window - ctx.t_start},
            "attempted": len(results), "failed": out["failed"],
            "memory_peak_bytes": int(peak), "numbers": numbers,
            "record": record, "trace": rec.trace, "notes": notes}


def _offer(ctx, tr, url, paths, root, service, timer, rec, tag):
    """One window of Poisson arrivals at tr["rate"] from the generator's
    process. -> (results, counters over the window, its start, arrivals)."""
    arrivals = schedule(tr, ctx.seconds, len(paths), ctx.seed)
    work = os.path.join(root, f"loadgen{tag}")
    os.makedirs(work)
    sched_path = os.path.join(work, "schedule.json")
    out_path = os.path.join(work, "results.json")
    lead = 1.0  # the generator's own start, inside set-up
    t_window = None
    before = _counters(service, timer)
    gen = None

    def launch():
        """The generator starts, and the window opens when it is due."""
        nonlocal gen, t_window
        t_window = time.time() + lead
        with open(sched_path, "w") as f:
            json.dump({"url": url, "start_at": t_window,
                       "timeout_s": tr["request_timeout_s"],
                       "threads": tr["client_threads"],
                       "requests": [[t, paths[v]] for t, v in arrivals]}, f)
        gen = subprocess.Popen(
            [sys.executable, "-m", "benchmark.yardstick.loadgen",
             sched_path, out_path], cwd=ctx.root,
            env=dict(os.environ, PYTHONPATH=ctx.root))
        time.sleep(max(0.0, t_window - time.time()))

    try:
        with rec.window(lambda: gen.wait(
                timeout=ctx.seconds + tr["request_timeout_s"] + 60),
                before=launch):
            pass
    finally:
        if gen is not None and gen.poll() is None:
            gen.kill()
            gen.wait()
    if gen.returncode != 0:
        raise RuntimeError(f"the load generator exited {gen.returncode}")
    after = _counters(service, timer)
    with open(out_path) as f:
        results = json.load(f)
    return (results, {k: after[k] - before[k] for k in after}, t_window,
            arrivals)


def _outcome(results, counters, t_window, arrivals, seconds) -> dict:
    """The window's end-to-end numbers, every request counted: a request
    that failed misses every limit (its latency counts as unbounded)."""
    ok = [_answered(r) for r in results]
    lat = [(r[2] - r[0]) * 1e3 if good else float("inf")
           for r, good in zip(results, ok)]
    done = max((r[2] for r in results), default=t_window)
    window_s = max(float(seconds), done - t_window)
    p95 = _percentile(lat, 0.95) if results else float("inf")
    return {"ok": ok, "failed": len(results) - sum(ok),
            "p95_ms": p95 if p95 != float("inf") else 1e9,
            "p50_ms": (_percentile(lat, 0.5) if results and
                       _percentile(lat, 0.5) != float("inf") else 1e9),
            "served_per_s": sum(ok) / window_s,
            "offered": len(results) / float(seconds),
            "late_ms": 1e3 * max((r[1] - r[0] for r in results),
                                 default=0.0),
            "mean_batch": (counters["batched_requests"]
                           / max(counters["batches"], 1))}


def _answered(result) -> bool:
    """A reply with HTTP 200 whose body is a result, not an error."""
    if result[3] != 200:
        return False
    try:
        return "error" not in json.loads(result[4])
    except ValueError:
        return False


def _post_ok(url: str, path: str) -> None:
    from benchmark.yardstick.loadgen import _send

    status, body = _send(url, path, 120.0)
    if status != 200 or "error" in json.loads(body):
        raise RuntimeError(f"a set-up request failed: {status} {body}")


def _counters(service, timer) -> dict:
    b, e = service.batcher, service.engine.stats()
    return {"batched_requests": b.n_requests, "batches": b.n_batches,
            "dispatches": e["dispatches"],
            "device_seconds": e["device_seconds"],
            "pack_seconds": timer.seconds, "packed_videos": timer.videos}


def _compare(net, params, results, ok, arrivals, paths, frames, embed, names,
             tr, seed, device) -> dict:
    """The sample's served top-k against the reference's similarities."""
    rng = np.random.default_rng(weights.subseed(seed, "sample"))
    n = len(results)
    if n == 0:
        return {"unanswered": 1}
    k = min(tr["sample"], n)
    pick = set(rng.choice(n, k, replace=False).tolist())
    pick.add(max(range(n), key=lambda i: frames[arrivals[i][1]]))
    pick = sorted(pick)
    unanswered = sum(not ok[i] for i in pick)
    answered = [i for i in pick if ok[i]]
    index = {c: i for i, c in enumerate(names)}
    served = []
    for i in answered:
        body = json.loads(results[i][4])
        served.append([(index[t["class"]], t["similarity"])
                       for t in body["topk"]])
    sims = reference.similarities(
        net, params, [paths[arrivals[i][1]] for i in answered], embed,
        tr["n_clips"], device)
    numbers = checks.serve_numbers(served, sims)
    numbers["unanswered"] = unanswered
    return numbers
