"""Port a torch checkpoint to a framework-native .npz (offline tool).

The port's copy of zeroshotvideoclassification_tpu/tools/port_checkpoint.py:
the same flags, the same npz (members, shapes, dtypes, values and meta) and
the same message, built from the port's pieces: train/checkpoint.
torch_source reads the file and tells its kind, models/bridge.to_jax
lays the tensors out as the JAX package's trees, and the npz keeps the
layout of the JAX package's porting.save_ported_npz (flat `params::...` /
`model_state::...` keys, `__step__` 0, `__meta__` {"epoch": -1,
"accuracy": 0.0, "ported_from": "<kind>:<src>"}).

Sources (auto-detected from the state_dict keys):
  * torchvision video-resnet weights — r3d_18 / mc3_18 / r2plus1d_18
    (the pretrained URLs vendored in the reference's resnet.py:11-15)
  * DavideA c3d.pickle (the reference's network.py:129-130)
  * the reference fork's own checkpoint.pth.tar (DataParallel state_dict,
    the reference's main.py:114-124)

A backbone-only source (torchvision, c3d.pickle) gives the backbone's
tensors only; the head stays at its init where the npz is loaded. Output:
checkpoint-format npz loadable by `--weights` (train.warm_start) of either
package and auto-discovered by the trainer when `--nopretrained` is NOT
set (the reference's pretrained=True path made real — quirk #3).

Usage:
  python -m zeroshotvideoclassification_tpu_torch.tools.port_checkpoint \
      --src r2plus1d_18-91a641e6.pth --network r2plus1d_18 \
      --out assets/pretrained/r2plus1d_18.npz
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

HEAD_KEYS = {
    "mlp": ("output2emb_proj.layers.0.weight", "output2emb_proj.layers.0.bias",
            "output2emb_proj.layers.1.weight", "output2emb_proj.layers.1.bias"),
    "regressor": ("regressor.weight", "regressor.bias"),
}


def backbone_keys(network: str):
    """The port's state_dict keys of `network`'s backbone (num_batches_
    tracked aside, which the JAX package does not keep)."""
    from zeroshotvideoclassification_tpu_torch.config import Config
    from zeroshotvideoclassification_tpu_torch.models import get_network

    with torch.device("meta"):
        model = get_network(Config(network=network, head="mlp"))
    head = {k for keys in HEAD_KEYS.values() for k in keys}
    return [k for k in model.state_dict()
            if k not in head and not k.endswith("num_batches_tracked")]


def port_state_dict(sd, kind: str, network: str, head: str):
    """(params, model_state) trees of the JAX package's layouts from a
    source's tensors: `network`'s backbone, and for a reference checkpoint
    the head `head` asks for (the mlp head's fc1 / fc2, else the
    regressor), as porting.port_any reads them. A tensor the backbone or
    head needs and the source lacks raises KeyError."""
    from zeroshotvideoclassification_tpu_torch.models import bridge

    keys = backbone_keys(network)
    if kind == "reference":
        keys += HEAD_KEYS["mlp" if head == "mlp" else "regressor"]
    return bridge.to_jax({k: sd[k] for k in keys})


def save_ported_npz(out_path: str, params, state, source: str = "") -> None:
    """Write the trees in the checkpoint layout (params::... /
    model_state::... flat keys), so either package's warm_start reads
    them."""
    from zeroshotvideoclassification_tpu_torch.models.bridge import flatten

    payload = {}
    for section, tree in (("params", params), ("model_state", state)):
        for k, v in flatten(tree).items():
            payload[f"{section}::{k}"] = v
    payload["__step__"] = np.zeros((), np.int32)
    meta = {"epoch": -1, "accuracy": 0.0, "ported_from": source}
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    with open(out_path, "wb") as f:
        np.savez(f, __meta__=json.dumps(meta), **payload)


def port_checkpoint(src: str, network: str, head: str, out: str) -> str:
    from zeroshotvideoclassification_tpu_torch.train.checkpoint import (
        torch_source,
    )

    sd, kind = torch_source(src)
    params, state = port_state_dict(sd, kind, network, head)
    save_ported_npz(out, params, state, source=f"{kind}:{src}")
    return kind


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--src", required=True, help="torch .pth/.pth.tar/.pickle")
    p.add_argument("--network", required=True,
                   help="r2plus1d_18 | r3d_18 | mc3_18 | c3d")
    p.add_argument("--head", default="mlp", choices=["mlp", "linear", "c3d"],
                   help="head layout for full reference checkpoints")
    p.add_argument("--out", required=True, help="output .npz path")
    args = p.parse_args(argv)
    kind = port_checkpoint(args.src, args.network, args.head, args.out)
    print(f"ported {args.src} ({kind}) -> {args.out}")


if __name__ == "__main__":
    main()
