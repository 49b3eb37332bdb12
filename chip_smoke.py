#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port's serving path (one GPU).

    python3 chip_smoke.py [--json PATH]

Phases, each printing its own lines and aborting the run (non-zero exit, no
result line) if it fails:

  1. environment: torch / CUDA versions, the card's name and power limit
     (nvidia-smi), nvcc, whether triton imports;
  2. build: the CUDA kernels in zeroshotvideoclassification_tpu_torch/csrc
     with nvcc for sm_90a, timed;
  3. kernels against their plain PyTorch versions on the card, TF32 off:
     K1 (video transform) at the serving shape, buckets 8 and 32, in f32
     (atol 2e-6) and bf16 (1 ulp); K2 (BN epilogue) at every epilogue shape
     r2plus1d_18 produces at bucket 8 x 4 clips, f32 and bf16, with and
     without residual and ReLU. Kernel time beside the plain time (CUDA
     events, median);
  4. whole model: full-width r2plus1d_18 + mlp head, seeded weights with
     per-channel BN statistics (seeded scale and bias, running mean and
     variance measured on the clips), on the card in bf16 (the kernels'
     path) and in f32, each against the plain CPU f32 forward of the same
     clips;
  5. serve: the port's InferenceEngine (bf16, max_batch 32) behind the
     shared HTTP server; two rounds of three concurrent POST /classify (1,
     5 and 10 videos), GET /healthz and /stats; every result checked
     against a direct f32 classification, the kernels' launch counts read around the
     requests; forward clips/s per bucket of the ladder, and at buckets 64
     and 128 (the serve CLI's default ladder, whose largest epilogues pass
     2^31 elements).

The line before the last is {"kernels": [...]}; the last is
{"ok": true, "device": {...}}. Without a CUDA device it exits 2 and prints
no result. --json PATH also writes every measurement to PATH. It imports
the port and the helpers in tests/torch_helpers.py (numpy and torch only).
"""

from __future__ import annotations

import argparse
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request

N_CLIPS, CLIP_LEN, SIZE, MAX_BATCH = 4, 16, 112, 32
N_VIDEOS, FRAMES, HEIGHT, WIDTH = 16, 64, 240, 320
BN_SEED = 1  # BN scale and bias of every model built here
# bf16 against the CPU f32 forward, per video: the two runs round at
# different places (bf16 conv inputs, outputs and epilogues on one side,
# none on the other, layers.py:71-74 in the JAX package), ~2^-9 relative per
# rounding over 37 layers. On a CPU, with these BN statistics, 16 videos x 4
# clips of 16x112x112 in bf16 stay at cosine >= 0.99998 per video, while an
# epilogue that applies each channel's affine to its neighbour falls to
# 0.53-0.56.
BF16_COSINE_BAR = 0.999
DEVICE = "cuda:0"
RECORD = {}


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def say(*parts):
    print(*parts, flush=True)


def time_ms(fn, reps=10):
    """Median device time of fn() in ms (CUDA events, after one warm-up)."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def phase_env():
    import torch

    say(f"[env] python {sys.version.split()[0]}  torch {torch.__version__}  "
        f"torch.version.cuda {torch.version.cuda}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0].strip()
    say(smi)
    from zeroshotvideoclassification_tpu_torch import _build

    nvcc = subprocess.run([_build.nvcc_path(), "--version"],
                          capture_output=True, text=True, check=True,
                          timeout=60).stdout.strip().splitlines()[-1]
    try:
        import triton

        tri = f"triton {triton.__version__} imports"
    except ImportError as e:
        tri = f"triton does not import ({e})"
    say(f"[env] nvcc: {nvcc} | {tri} | device 0: "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    RECORD["env"] = {"torch": torch.__version__, "cuda": torch.version.cuda,
                     "nvidia_smi": smi, "nvcc": nvcc, "triton": tri}
    return smi


def phase_build():
    from zeroshotvideoclassification_tpu_torch import _build

    res = _build.build()
    _build.library()
    regs = [ln.strip() for ln in res.log.splitlines()
            if "registers" in ln or "spill" in ln]
    spills = [ln for ln in regs
              if "spill" in ln and " 0 bytes spill" not in ln]
    say(f"[build] {res.path.name} from {len(_build.sources())} sources: "
        f"{res.seconds:.2f} s (compiled={res.compiled}); "
        f"{len(regs)} ptxas lines, spills: {spills or 'none'}")
    RECORD["build"] = {"seconds": res.seconds, "compiled": res.compiled,
                       "ptxas": regs}


def make_videos(tmp):
    import numpy as np

    from torch_helpers import synthetic_clip

    paths = []
    for k in range(N_VIDEOS):
        p = os.path.join(tmp, f"video{k:02d}.npy")
        np.save(p, synthetic_clip(k, FRAMES, HEIGHT, WIDTH))
        paths.append(p)
    return paths


def host_batch(paths, bucket):
    """The serving engine's host half: decode + pack into one batch."""
    import numpy as np

    from zeroshotvideoclassification_tpu_torch.config import Config
    from zeroshotvideoclassification_tpu_torch.data.pipeline import (
        host_batch as pack,
    )

    cfg = Config(size=SIZE, clip_len=CLIP_LEN, n_clips=N_CLIPS)
    return pack(paths, cfg, bucket, ["c"], np.ones((1, 300), np.float32))


def phase_k1(paths, dev):
    import torch

    from zeroshotvideoclassification_tpu_torch.ops.resample import (
        fused_video_transform,
    )
    from torch_helpers import bf16_ulps
    from zeroshotvideoclassification_tpu_torch.ops.resample_cuda import (
        fused_video_transform_cuda,
    )

    out = {"max_abs_err": 0.0, "shapes": []}
    for bucket in (8, 32):
        hb = host_batch((paths * 2)[:bucket], bucket)
        args = [torch.from_numpy(a.copy()).to(dev) for a in
                (hb.canvas, hb.y0, hb.y1, hb.wy, hb.x0, hb.x1, hb.wx)]
        for j in (4, 5, 6):  # flip the odd samples: mirrored column taps
            args[j][1::2] = args[j][1::2].flip(1)
        b, t, hc, wc, _ = args[0].shape
        for dt in (torch.float32, torch.bfloat16):
            got = fused_video_transform_cuda(*args, out_dtype=dt)
            torch.cuda.synchronize()
            want = fused_video_transform(*args, out_dtype=dt)
            torch.cuda.synchronize()
            err = float((got.float() - want.float()).abs().max())
            ulps = bf16_ulps(got, want)
            if dt == torch.float32:
                check(err <= 2e-6, f"K1 f32 bucket {bucket}: {err}")
            else:
                check(ulps <= 1.0, f"K1 bf16 bucket {bucket}: {ulps} ulp")
            ms = time_ms(lambda: fused_video_transform_cuda(
                *args, out_dtype=dt))
            plain = time_ms(lambda: fused_video_transform(
                *args, out_dtype=dt), reps=5)
            gb = (args[0].numel() + got.numel() * got.element_size()) / 1e9
            row = {"bucket": bucket, "shape": [b, t, hc, wc, 3],
                   "dtype": str(dt).split(".")[-1], "max_abs_err": err,
                   "bf16_ulps": ulps, "ms": ms, "plain_ms": plain,
                   "GB_moved": gb, "GB_per_s": gb / (ms / 1e3)}
            out["shapes"].append(row)
            out["max_abs_err"] = max(out["max_abs_err"], err)
            say(f"[K1] bucket {bucket} canvas {b}x{t}x{hc}x{wc}x3 -> "
                f"{row['dtype']}: err {err:.3g} ({ulps:.2f} bf16 ulp)  "
                f"kernel {ms:.3f} ms ({row['GB_per_s']:.0f} GB/s)  "
                f"plain {plain:.3f} ms")
    serving = next(r for r in out["shapes"]
                   if r["bucket"] == 8 and r["dtype"] == "bfloat16")
    out["ms"], out["plain_ms"] = serving["ms"], serving["plain_ms"]
    RECORD["k1"] = out
    return out


def epilogue_calls(model, x):
    """(shape [N,T,H,W,C], residual?, relu?) -> count over one forward."""
    import torch

    from zeroshotvideoclassification_tpu_torch.models.layers import (
        BatchNorm3d,
    )
    from zeroshotvideoclassification_tpu_torch.train import eval_step

    calls = {}

    def hook(mod, args, kwargs):
        s = args[0].shape
        key = ((s[0], *s[2:], s[1]), kwargs.get("residual") is not None,
               bool(kwargs.get("relu", False)))
        calls[key] = calls.get(key, 0) + 1

    hs = [m.register_forward_pre_hook(hook, with_kwargs=True)
          for m in model.modules() if isinstance(m, BatchNorm3d)]
    try:
        eval_step(model, x)
        torch.cuda.synchronize()
    finally:
        for h in hs:
            h.remove()
    return calls


def phase_k2(calls, dev):
    import torch

    from torch_helpers import bf16_ulps
    from zeroshotvideoclassification_tpu_torch.ops.bn_cuda import (
        bn_apply_relu_cuda,
        bn_apply_relu_plain,
    )

    g = torch.Generator(device=dev).manual_seed(0)
    out = {"max_abs_err": 0.0, "shapes": [], "ms": 0.0, "plain_ms": 0.0}
    shapes = sorted({k[0] for k in calls}, key=lambda s: -math.prod(s))
    for shape in shapes:
        c = shape[-1]
        stats = [torch.rand(c, device=dev, generator=g) * 1.5 + 0.5,
                 torch.randn(c, device=dev, generator=g),
                 torch.randn(c, device=dev, generator=g),
                 torch.rand(c, device=dev, generator=g) * 2.7 + 0.3]
        x32 = torch.randn(shape, device=dev, generator=g)
        r32 = torch.randn(shape, device=dev, generator=g)
        for dt in (torch.float32, torch.bfloat16):
            x, r = x32.to(dt), r32.to(dt)
            for res in (False, True):
                for relu in (False, True):
                    rr = r if res else None
                    got = bn_apply_relu_cuda(x, *stats, rr, relu)
                    torch.cuda.synchronize()
                    want = bn_apply_relu_plain(x, *stats, rr, relu)
                    torch.cuda.synchronize()
                    err = float((got.float() - want.float()).abs().max())
                    ulps = bf16_ulps(got, want)
                    if dt == torch.float32:
                        check(err <= 2e-6, f"K2 f32 {shape} res={res} "
                                           f"relu={relu}: {err}")
                    else:
                        check(ulps <= 1.0, f"K2 bf16 {shape} res={res} "
                                           f"relu={relu}: {ulps} ulp")
                    out["max_abs_err"] = max(out["max_abs_err"], err)
                    n = calls.get((shape, res, relu), 0)
                    if not n:
                        continue
                    ms = time_ms(lambda: bn_apply_relu_cuda(
                        x, *stats, rr, relu))
                    plain = time_ms(lambda: bn_apply_relu_plain(
                        x, *stats, rr, relu), reps=5)
                    gb = x.numel() * x.element_size() * (3 if res else 2) / 1e9
                    row = {"shape": list(shape), "dtype": str(dt)[6:],
                           "residual": res, "relu": relu, "calls": n,
                           "max_abs_err": err, "bf16_ulps": ulps, "ms": ms,
                           "plain_ms": plain, "GB_per_s": gb / (ms / 1e3)}
                    out["shapes"].append(row)
                    if dt == torch.bfloat16:
                        out["ms"] += n * ms
                        out["plain_ms"] += n * plain
                    say(f"[K2] {'x'.join(map(str, shape))} {row['dtype']} "
                        f"res={int(res)} relu={int(relu)} x{n}: err "
                        f"{err:.3g} ({ulps:.2f} ulp)  kernel {ms:.3f} ms "
                        f"({row['GB_per_s']:.0f} GB/s)  plain {plain:.3f} ms")
        del x32, r32, x, r
    say(f"[K2] all {len(shapes)} shapes x 8 variants agree; per bf16 forward "
        f"at bucket 8: kernel {out['ms']:.3f} ms, plain {out['plain_ms']:.3f} "
        f"ms over {sum(calls.values())} epilogues")
    RECORD["k2"] = out
    return out


def phase_model(paths, dev):
    import numpy as np
    import torch

    from torch_helpers import calibrate_bn, copy_bn
    from zeroshotvideoclassification_tpu_torch.cli.infer import load_model
    from zeroshotvideoclassification_tpu_torch.config import Config
    from zeroshotvideoclassification_tpu_torch.data.pipeline import (
        device_batch,
    )
    from zeroshotvideoclassification_tpu_torch.ops.cdist import (
        cosine_distances,
    )
    from zeroshotvideoclassification_tpu_torch.train import eval_step

    def cfg(dt):
        return Config(network="r2plus1d_18", head="mlp", size=SIZE,
                      clip_len=CLIP_LEN, n_clips=N_CLIPS, compute_dtype=dt)

    hb = host_batch(paths[:2], 2)
    m32, _ = load_model(cfg("float32"), None, dev)
    calibrate_bn(m32, device_batch(hb, N_CLIPS, CLIP_LEN, torch.float32,
                                   dev)["x"], BN_SEED)
    m_cpu = copy_bn(m32, load_model(cfg("float32"), None, "cpu")[0])
    m16 = copy_bn(m32, load_model(cfg("bfloat16"), None, dev)[0])
    t0 = time.perf_counter()
    e_cpu = eval_step(m_cpu, device_batch(hb, N_CLIPS, CLIP_LEN,
                                          torch.float32, "cpu")["x"])
    cpu_s = time.perf_counter() - t0
    e32 = eval_step(m32, device_batch(hb, N_CLIPS, CLIP_LEN, torch.float32,
                                      dev)["x"]).cpu()
    e16 = eval_step(m16, device_batch(hb, N_CLIPS, CLIP_LEN, torch.bfloat16,
                                      dev)["x"]).cpu()
    err32 = float((e32 - e_cpu).abs().max())
    cos16 = torch.nn.functional.cosine_similarity(e16, e_cpu, dim=1)
    say(f"[model] r2plus1d_18+mlp, 2 videos x {N_CLIPS} clips x "
        f"{CLIP_LEN}x{SIZE}x{SIZE}: GPU f32 vs CPU f32 max abs "
        f"{err32:.3g} (bar 1e-4); GPU bf16 vs CPU f32 cosine "
        f"{[round(float(c), 6) for c in cos16]} (bar {BF16_COSINE_BAR}); "
        f"CPU forward {cpu_s:.1f} s")
    check(e_cpu.shape == (2, 300) and bool(torch.isfinite(e16).all()),
          "embedding shape / finiteness")
    check(err32 <= 1e-4, f"GPU f32 vs CPU f32: {err32}")
    check(float(cos16.min()) >= BF16_COSINE_BAR, f"bf16 cosine {cos16}")

    # the direct f32 classification: every video's f32 embedding is a class
    hb_all = host_batch(paths, N_VIDEOS)
    proto = eval_step(m32, device_batch(hb_all, N_CLIPS, CLIP_LEN,
                                        torch.float32, dev)["x"])
    dist = cosine_distances(proto, proto).cpu().numpy()
    off = dist + np.eye(N_VIDEOS) * 9
    say(f"[model] 16 class prototypes (f32 embeddings of the 16 videos): "
        f"smallest distance between two = {off.min():.3g}")
    check(off.min() > 1e-4, "prototypes too close to rank")
    RECORD["model"] = {"gpu_f32_vs_cpu_max_abs": err32,
                       "bf16_vs_cpu_cosine": [float(c) for c in cos16],
                       "prototype_min_distance": float(off.min())}
    return m32, m16, proto.cpu().numpy(), dist.argmin(axis=1)


def post(url, payload):
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 method="POST")
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=600) as r:
        body = json.loads(r.read())
        check(r.status == 200, f"POST {url}: {r.status}")
    return body, time.perf_counter() - t0


def get(url):
    with urllib.request.urlopen(url, timeout=60) as r:
        return json.loads(r.read())


def phase_serve(paths, m32, proto, expected, dev, smi):
    import torch
    from torch_helpers import copy_bn

    from zeroshotvideoclassification_tpu_torch.ops.bn_cuda import (
        bn_apply_relu_cuda,
    )
    from zeroshotvideoclassification_tpu_torch.ops.resample_cuda import (
        fused_video_transform_cuda,
    )
    from zeroshotvideoclassification_tpu_torch.serve import (
        InferenceEngine,
        start_server,
    )

    names = [f"video{k:02d}" for k in range(N_VIDEOS)]
    engine = InferenceEngine(
        names, proto, network="r2plus1d_18", head="mlp", weights=None,
        n_clips=N_CLIPS, clip_len=CLIP_LEN, size=SIZE, max_batch=MAX_BATCH,
        compute_dtype="bfloat16", device=dev)
    # phase 4's weights: the same seeded init, and its BN statistics
    copy_bn(m32, engine.model)
    server = service = None
    try:
        t0 = time.perf_counter()
        engine.warmup()
        say(f"[serve] warmup of ladder {engine.batch_buckets}: "
            f"{time.perf_counter() - t0:.2f} s")
        server, service = start_server(engine, port=0)
        url = f"http://127.0.0.1:{server.server_address[1]}"
        requests = [paths[:1], paths[1:6], paths[6:16]]
        # two rounds of the same concurrent requests: the first dispatch on
        # the batcher's own thread pays that thread's CUDA library set-up
        rounds = [[None] * len(requests) for _ in range(2)]

        def send(rnd, i):
            rounds[rnd][i] = post(url + "/classify", {"videos": requests[i]})

        fused_video_transform_cuda.launches = 0
        bn_apply_relu_cuda.launches = 0
        for rnd in range(len(rounds)):
            threads = [threading.Thread(target=send, args=(rnd, i))
                       for i in range(len(requests))]
            for th in threads:
                th.start()
            for th in threads:
                th.join(timeout=600)
        launches = {"video_transform": fused_video_transform_cuda.launches,
                    "bn_apply_relu": bn_apply_relu_cuda.launches}
        check(all(r is not None for rnd in rounds for r in rnd),
              "a request failed")
        health = get(url + "/healthz")
        stats = get(url + "/stats")
    finally:
        if server is not None:
            server.shutdown()
            server.server_close()
            service.close()
        engine.close()
    check(health["status"] == "ok", f"healthz {health}")
    lat = []
    for rnd, results in enumerate(rounds):
        lat.append([secs for _, secs in results])
        for req, (body, _) in zip(requests, results):
            check(len(body["results"]) == len(req), "one result per video")
            for r, path in zip(body["results"], req):
                check(set(r) == {"video", "top_class", "topk"}
                      and r["video"] == path and len(r["topk"]) == 5
                      and all(set(t) == {"class", "similarity"}
                              for t in r["topk"]), f"result schema: {r}")
                want = names[int(expected[paths.index(path)])]
                check(r["top_class"] == want,
                      f"{path}: served {r['top_class']}, f32 says {want}")
        say(f"[serve] round {rnd + 1}: {len(requests)} concurrent POST "
            f"/classify of {[len(r) for r in requests]} videos, latency "
            f"{[round(s, 3) for s in lat[-1]]} s  ({smi})")
    say(f"[serve] every top_class = the direct f32 classification; "
        f"dispatches {stats['engine']['batch_buckets']}, device_seconds "
        f"{stats['engine']['device_seconds']}; launches {launches}")
    check(launches["video_transform"] > 0 and launches["bn_apply_relu"] > 0,
          f"main path launched no kernel: {launches}")

    # forward throughput per bucket (model only, input already on the card),
    # on this ladder and on the serve CLI's default one (max_batch 128)
    fwd = {}
    model = engine.model
    from zeroshotvideoclassification_tpu_torch.train import eval_step

    for b in engine.batch_buckets + [64, 128]:
        x = torch.rand((b, N_CLIPS, CLIP_LEN, SIZE, SIZE, 3), device=dev,
                       dtype=torch.float32).sub_(0.5).to(torch.bfloat16)
        ms = time_ms(lambda: eval_step(model, x), reps=5)
        fwd[b] = {"ms": ms, "clips_per_s": b * N_CLIPS / (ms / 1e3)}
        say(f"[serve] forward bucket {b} ({b * N_CLIPS} clips) bf16: "
            f"{ms:.2f} ms = {fwd[b]['clips_per_s']:.1f} clips/s  ({smi})")
        del x
    RECORD["serve"] = {"latency_s": lat, "launches": launches,
                       "stats": stats, "forward": fwd}
    return launches


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--json", default=None,
                   help="also write every measurement to this file")
    args = p.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this needs "
              "an NVIDIA GPU", file=sys.stderr)
        return 2
    import zeroshotvideoclassification_tpu_torch  # noqa: F401  (the port)

    # the helpers shared with the port's tests (numpy and torch only)
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(
        __file__)), "tests"))

    dev = torch.device(DEVICE)
    # the serving settings (cli/infer.build_scoring_state)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.benchmark = True

    smi = phase_env()
    phase_build()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        t0 = time.perf_counter()
        paths = make_videos(tmp)
        say(f"[data] {N_VIDEOS} seeded clips {FRAMES}x{HEIGHT}x{WIDTH}x3 "
            f"uint8 written in {time.perf_counter() - t0:.1f} s")
        k1 = phase_k1(paths, dev)
        m32, m16, proto, expected = phase_model(paths, dev)
        calls = epilogue_calls(m16, torch.zeros(
            (8, N_CLIPS, CLIP_LEN, SIZE, SIZE, 3), device=dev,
            dtype=torch.bfloat16))
        del m16
        k2 = phase_k2(calls, dev)
        launches = phase_serve(paths, m32, proto, expected, dev, smi)
        del m32

    check(not {"jax", "jaxlib"} & set(sys.modules), "JAX was imported")
    src = "zeroshotvideoclassification_tpu_torch/csrc/"
    kernels = {"kernels": [
        {"name": "video_transform", "route": "cuda",
         "source": src + "video_transform.cu",
         "replaces": "zeroshotvideoclassification_tpu/ops/"
                     "resample_pallas.py:74",
         "launches": launches["video_transform"],
         "max_abs_err": k1["max_abs_err"], "ms": k1["ms"],
         "plain_ms": k1["plain_ms"]},
        {"name": "bn_apply_relu", "route": "cuda",
         "source": src + "bn_apply_relu.cu",
         "replaces": "zeroshotvideoclassification_tpu/ops/bn_pallas.py:131",
         "launches": launches["bn_apply_relu"],
         "max_abs_err": k2["max_abs_err"], "ms": k2["ms"],
         "plain_ms": k2["plain_ms"]},
    ]}
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)),
                    exist_ok=True)
        with open(args.json, "w") as f:
            json.dump({**RECORD, **kernels}, f, indent=1, default=str)
    say(smi)
    say(json.dumps(kernels))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
