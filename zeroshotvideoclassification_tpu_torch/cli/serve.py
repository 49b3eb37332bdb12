"""Always-on zero-shot classification service (HTTP, micro-batched), on one
GPU.

Counterpart of zeroshotvideoclassification_tpu/cli/serve.py: the same flags
(its parser, imported) plus --device, and the same server
(serve_forever, shared), in front of the port's InferenceEngine.

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

from zeroshotvideoclassification_tpu.cli.infer import resolve_classes
from zeroshotvideoclassification_tpu.cli.serve import (
    build_arg_parser as _jax_arg_parser,
)
from zeroshotvideoclassification_tpu_torch.serve import (
    InferenceEngine,
    serve_forever,
)


def build_arg_parser() -> argparse.ArgumentParser:
    p = _jax_arg_parser()
    p.description = ("Serve zero-shot video classification over HTTP "
                     "(PyTorch port, one GPU)")
    p.add_argument("--device", default="cuda",
                   help="torch device (cuda, cuda:1, cpu); cuda without a "
                        "GPU is an error")
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
              f"{args.max_batch}, window={args.max_wait_ms}ms, device="
              f"{engine.device})", file=sys.stderr)
        serve_forever(engine, args.host, args.port,
                      max_wait_s=args.max_wait_ms / 1e3,
                      data_root=args.data_root,
                      pipeline_depth=args.pipeline_depth,
                      drain_timeout=args.drain_timeout)
    finally:
        engine.close()  # the CLI owns the engine's decode pool


if __name__ == "__main__":
    main()
