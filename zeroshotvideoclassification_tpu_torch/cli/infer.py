"""Zero-shot video classification, one shot, on one device.

Counterpart of zeroshotvideoclassification_tpu/cli/infer.py: checkpoint +
class names + videos -> ranked predictions, one JSON line per video.

  python -m zeroshotvideoclassification_tpu_torch.cli.infer \\
      --weights runs/.../checkpoint.npz --network r2plus1d_18 \\
      --classes "playing guitar" "riding a horse" --videos clip1.npy \\
      --device cuda

The flags and the class-name embedding (add_class_and_model_args,
resolve_classes, build_class_embeddings) are copies of the JAX CLI's, and the
host pipeline is the port's own copy (data/pipeline.py). --network and
--head pick the model as the trainer does (models/heads.get_network: the
VideoResNets, C3D, resnet18 = R3D-18 + the linear head); a caller's
namespace may also carry clip_pool ('feature' when absent, as in the JAX
CLI, which has no such flag). --weights takes a JAX
npz checkpoint, loaded strictly; without one the model is a seeded random
init. --device defaults to cuda; asking for cuda without a GPU raises.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional, Sequence

import numpy as np
import torch

from zeroshotvideoclassification_tpu_torch.config import (
    Config,
    torch_dtype,
    transform_dtype,
)
from zeroshotvideoclassification_tpu_torch.data.datasets import VideoTable
from zeroshotvideoclassification_tpu_torch.data.decode import detect_loader
from zeroshotvideoclassification_tpu_torch.data.pipeline import (
    HostPipeline,
    device_batch,
)
from zeroshotvideoclassification_tpu_torch.models import get_network
from zeroshotvideoclassification_tpu_torch.models.layers import init_weights
from zeroshotvideoclassification_tpu_torch.ops.cdist import cosine_distances
from zeroshotvideoclassification_tpu_torch.text import (
    SyntheticWordVectors,
    classes2embedding,
    load_word2vec,
)
from zeroshotvideoclassification_tpu_torch.train import (
    eval_step,
    load_checkpoint,
)

INIT_SEED = 0


def build_class_embeddings(class_names: Sequence[str], rule: str,
                           args) -> np.ndarray:
    """[C, 300] unit rows via the training-time embedding path."""
    if args.synthetic_word2vec:
        wv = SyntheticWordVectors()
    else:
        wv = load_word2vec(args.word2vec_path, args.word2vec_cache)
    return classes2embedding(rule, class_names, wv)


def resolve_device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {device}: no CUDA device is available")
    return device


def resolve_devices(device) -> List[torch.device]:
    """The serving engine's devices, one replica each: a plain `cuda` (no
    index) is every visible GPU (torch.cuda.device_count(), which
    CUDA_VISIBLE_DEVICES bounds), as the JAX engine meshes every local
    chip; `cuda:N` is that GPU and `cpu` one CPU replica; a list or tuple
    names each replica's device (an entry may repeat). cuda without a GPU
    raises."""
    if isinstance(device, (list, tuple)):
        if not device:
            raise ValueError("no devices")
        return [resolve_device(d) for d in device]
    device = resolve_device(device)
    if device.type == "cuda" and device.index is None:
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [device]


def load_model(config, weights: Optional[str], device):
    """-> (model in eval mode on `device`, checkpoint meta or None).

    A JAX npz checkpoint is loaded strictly (train/checkpoint.py); without
    one the weights are a random init from a torch.Generator seeded with
    INIT_SEED. Convs (C3D's biases with them) run in Config.compute_dtype,
    in channels-last-3d; C3D's fc6 and the heads stay float32."""
    device = resolve_device(device)
    with torch.device("meta"):
        model = get_network(config)
    model = model.to_empty(device="cpu")
    meta = None
    if weights and weights != "none":
        meta = load_checkpoint(weights, model)
    else:
        init_weights(model, torch.Generator().manual_seed(INIT_SEED))
    model.set_compute_dtype(torch_dtype(config.compute_dtype))
    model = model.to(device=device, memory_format=torch.channels_last_3d)
    return model.eval(), meta


def build_scoring_state(config, weights: Optional[str], device="cuda"):
    """(model, eval_step) for inference — shared by this CLI and the serving
    engine (serve/engine.py); Config.network/head pick the model.

    Process-wide cuDNN/CUDA settings, as the JAX package's XLA settings:
    float32 means full float32 ('highest' precision there), so TF32 is
    turned off for cuDNN convolutions and CUDA matmuls (bf16 work is
    unaffected); and cuDNN times its algorithms for each new conv shape and
    keeps the fastest (XLA autotunes its convs when it compiles), which the
    engine's warmup pays once per dispatch bucket."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.benchmark = True
    model, meta = load_model(config, weights, device)
    if meta is not None:
        print(f"LOADED CHECKPOINT: {weights} (epoch {meta.get('epoch')}, "
              f"acc {meta.get('accuracy')})", file=sys.stderr)
    else:
        print(f"WARNING: no --weights; scoring a random-init model "
              f"(seed {INIT_SEED})", file=sys.stderr)
    return model, eval_step


def rank_results(paths: Sequence[str], dist: np.ndarray, ok: np.ndarray,
                 class_names: Sequence[str], top_k: int) -> List[dict]:
    """Cosine distances [n, C] -> one result dict per path (the JAX CLI's
    response schema)."""
    rank = np.argsort(dist, axis=1)
    k = min(top_k, len(class_names))
    results = []
    for i, path in enumerate(paths):
        if not ok[i]:
            results.append({"video": path, "error": "decode failed"})
            continue
        results.append({
            "video": path,
            "top_class": class_names[int(rank[i, 0])],
            "topk": [{"class": class_names[int(c)],
                      "similarity": round(float(1.0 - dist[i, c]), 6)}
                     for c in rank[i, :k]],
        })
    return results


def classify_videos(videos: Sequence[str], class_names: Sequence[str],
                    class_embed: np.ndarray, args) -> List[dict]:
    """Embed every video (n_clips TSN windows, clip-mean) and rank classes,
    on args.device."""
    device = resolve_device(args.device)
    config = Config(network=args.network, head=args.head, bs=args.bs,
                    clip_len=args.clip_len, size=args.size,
                    n_clips=args.n_clips, compute_dtype=args.compute_dtype,
                    decode_scale=getattr(args, "decode_scale", 1),
                    clip_pool=getattr(args, "clip_pool", "feature"))
    model, step = build_scoring_state(config, args.weights, device)
    class_embed_dev = torch.from_numpy(
        np.asarray(class_embed, np.float32)).to(device)
    # one homogeneous VideoTable per loader kind; results keyed by POSITION
    results = [None] * len(videos)
    by_loader = {}
    for pos, v in enumerate(videos):
        by_loader.setdefault(detect_loader(v), []).append((pos, v))
    for loader, entries in by_loader.items():
        positions = [pos for pos, _ in entries]
        paths = [v for _, v in entries]
        table = VideoTable(
            name="infer", fnames=np.asarray(paths, object),
            label_idx=np.zeros(len(paths), np.int32),
            classes=list(class_names), class_embed=class_embed,
            loader=loader, is_validation=True, n_clips=args.n_clips)
        embs, weights = [], []
        for host in HostPipeline(table, config, args.bs, seed=0):
            batch = device_batch(host, table.n_clips, config.clip_len,
                                 transform_dtype(config), device)
            embs.append(step(model, batch["x"]))
            weights.append(host.weight)
        emb = torch.cat(embs)[:len(paths)]
        ok = np.concatenate(weights)[:len(paths)] > 0
        dist = cosine_distances(emb, class_embed_dev).cpu().numpy()
        for pos, r in zip(positions, rank_results(
                paths, dist, ok, list(class_names), args.top_k)):
            results[pos] = r
    return results


def add_class_and_model_args(p: argparse.ArgumentParser) -> None:
    """Class-embedding + model flags shared with cli/serve.py."""
    p.add_argument("--classes", nargs="*", default=None,
                   help="candidate class names (zero-shot: any names)")
    p.add_argument("--classes_file", default=None,
                   help="file with one class name per line")
    p.add_argument("--class_rule", default="kinetics",
                   choices=["ucf101", "hmdb51", "kinetics", "activitynet",
                            "sun"],
                   help="name->words rule set (text/class_names.py)")
    p.add_argument("--weights", default="none")
    p.add_argument("--network", default="r2plus1d_18")
    p.add_argument("--head", default="mlp")
    p.add_argument("--n_clips", type=int, default=4,
                   help="TSN windows per video (clip-mean pooled)")
    p.add_argument("--clip_len", type=int, default=16)
    p.add_argument("--size", type=int, default=112)
    p.add_argument("--bs", type=int, default=8)
    p.add_argument("--top_k", type=int, default=5)
    p.add_argument("--compute_dtype", default="bfloat16",
                   choices=["bfloat16", "float32"])
    p.add_argument("--decode_scale", type=int, default=1,
                   choices=[1, 2, 4, 8],
                   help="max libjpeg DCT-scale denominator for frame-dir "
                        "JPEG decode (1 = exact reference decode parity; "
                        "docs/TUNING.md)")
    p.add_argument("--word2vec_path",
                   default="./assets/GoogleNews-vectors-negative300.bin")
    p.add_argument("--word2vec_cache", default="./assets/word2vec_cache.npz")
    p.add_argument("--synthetic_word2vec", action="store_true",
                   help="deterministic hash embeddings (no word2vec asset; "
                        "tests/smoke only)")
    p.add_argument("--class_embed", default=None,
                   help="precomputed class embeddings: .npz with 'classes' "
                        "and 'embeddings' [C,300] (skips word2vec)")


def resolve_classes(args):
    """(class_names, class_embed [C,300] unit rows) from the shared flags."""
    if args.class_embed:
        z = np.load(args.class_embed, allow_pickle=False)
        class_names = [str(c) for c in z["classes"]]
        class_embed = np.asarray(z["embeddings"], np.float32)
        if class_embed.ndim != 2 or len(class_names) != len(class_embed):
            raise SystemExit("--class_embed: need classes[C], embeddings[C,D]")
        class_embed /= np.maximum(
            np.linalg.norm(class_embed, axis=1, keepdims=True), 1e-12)
    else:
        class_names = list(args.classes or [])
        if args.classes_file:
            with open(args.classes_file) as f:
                class_names += [l.strip() for l in f if l.strip()]
        if not class_names:
            raise SystemExit("no classes: pass --classes, --classes_file "
                             "or --class_embed")
        class_embed = build_class_embeddings(class_names, args.class_rule,
                                             args)
    return class_names, class_embed


def build_arg_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Zero-shot classify videos against arbitrary class "
                    "names (PyTorch port)")
    p.add_argument("--videos", nargs="+", required=True,
                   help="frame dirs / video files / .npy clip stacks")
    add_class_and_model_args(p)
    p.add_argument("--device", default="cuda",
                   help="torch device (cuda, cuda:1, cpu); cuda without a "
                        "GPU is an error")
    return p


def main(argv=None):
    args = build_arg_parser().parse_args(argv)
    class_names, class_embed = resolve_classes(args)
    results = classify_videos(args.videos, class_names, class_embed, args)
    for r in results:
        print(json.dumps(r))
    return results


if __name__ == "__main__":
    main()
