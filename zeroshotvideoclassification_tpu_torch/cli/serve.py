"""Always-on zero-shot classification service (HTTP, micro-batched), on
every local GPU.

Counterpart of zeroshotvideoclassification_tpu/cli/serve.py: the same flags
(a copy of its parser) plus --device, and the same server (serve/server.py,
the port's copy), in front of the port's InferenceEngine. --device cuda
(the default) serves from every visible GPU, one replica each, each
dispatch split over them on its rows as the JAX engine splits it over its
'data' mesh; --device cuda:N serves from that GPU, cpu from the CPU.

  python -m zeroshotvideoclassification_tpu_torch.cli.serve \\
      --weights runs/.../checkpoint.npz --network r2plus1d_18 \\
      --classes "playing guitar" "riding a horse" --port 8000 --device cuda

  curl -s localhost:8000/classify -d '{"video": "/data/clip1.npy"}'
  curl -s localhost:8000/healthz
  curl -s localhost:8000/stats
"""

from __future__ import annotations

import argparse
import sys

from zeroshotvideoclassification_tpu_torch.cli.infer import (
    add_class_and_model_args,
    resolve_classes,
)
from zeroshotvideoclassification_tpu_torch.serve import (
    InferenceEngine,
    serve_forever,
)


def build_arg_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Serve zero-shot video classification over HTTP "
                    "(PyTorch port, every local GPU)")
    add_class_and_model_args(p)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--max_batch", type=int, default=128,
                   help="largest device batch; concurrent requests coalesce "
                        "up to this many per dispatch (the JAX CLI's "
                        "default). Each dispatch pads to the smallest shape "
                        "of an 8/16/32/64/max ladder that fits, so small "
                        "requests keep small latency")
    p.add_argument("--max_wait_ms", type=float, default=10.0,
                   help="batching window after the first queued request")
    p.add_argument("--warmup", action=argparse.BooleanOptionalAction,
                   default=True,
                   help="run the whole dispatch-shape ladder before "
                        "binding the port (no request waits for the "
                        "kernels' build or cuDNN's algorithm timing). "
                        "--no-warmup binds immediately")
    p.add_argument("--pipeline_depth", type=int, default=2,
                   help="packed batches allowed between the host decode "
                        "stage and the device dispatch stage (each holds "
                        "its canvases in host RAM; 0 disables pipelining "
                        "for the lowest memory footprint)")
    p.add_argument("--drain_timeout", type=float, default=30.0,
                   help="seconds a graceful shutdown (SIGTERM/Ctrl+C) "
                        "waits for already-accepted requests to finish "
                        "before failing them; size to the slowest "
                        "legitimate batch (a saturated max_batch of real "
                        "video decodes can exceed the default on a loaded "
                        "host)")
    p.add_argument("--data_root", default=None,
                   help="if set, reject /classify paths that resolve "
                        "outside this directory (recommended with a "
                        "non-loopback --host; by default any path readable "
                        "by the process can be probed/decoded)")
    p.add_argument("--device", default="cuda",
                   help="torch device (cuda: every visible GPU, one "
                        "replica each; cuda:1; cpu); cuda without a GPU is "
                        "an error")
    return p


def main(argv=None):
    args = build_arg_parser().parse_args(argv)
    class_names, class_embed = resolve_classes(args)
    engine = InferenceEngine(
        class_names, class_embed, network=args.network, head=args.head,
        weights=args.weights, n_clips=args.n_clips, clip_len=args.clip_len,
        size=args.size, max_batch=args.max_batch,
        compute_dtype=args.compute_dtype, top_k=args.top_k,
        decode_scale=args.decode_scale, device=args.device)
    try:
        if args.warmup:
            print(f"warming the dispatch ladder {engine.batch_buckets} ...",
                  file=sys.stderr)
            engine.warmup()
        print(f"serving {args.network} ({len(class_names)} classes) on "
              f"http://{args.host}:{args.port}  (max_batch="
              f"{args.max_batch}, window={args.max_wait_ms}ms, devices="
              f"{','.join(str(d) for d in engine.devices)}, data_shards="
              f"{engine.n_shards})", file=sys.stderr)
        serve_forever(engine, args.host, args.port,
                      max_wait_s=args.max_wait_ms / 1e3,
                      data_root=args.data_root,
                      pipeline_depth=args.pipeline_depth,
                      drain_timeout=args.drain_timeout)
    finally:
        engine.close()  # the CLI owns the engine's decode pool


if __name__ == "__main__":
    main()
