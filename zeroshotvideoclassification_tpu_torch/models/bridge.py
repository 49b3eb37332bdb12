"""Weights across the frameworks: JAX pytrees -> the port's state_dict.

from_jax(params, model_state) turns the JAX package's ZeroShotModel trees
(nested dicts of numpy arrays, as ZeroShotModel.init returns them or a
checkpoint stores them) into a state_dict for models.heads.ZeroShotModel:

  conv weights   DHWIO -> OIDHW
  linear weights [in, out] -> [out, in]
  BN             scale/bias/mean/var -> weight/bias/running_mean/running_var
                 (+ num_batches_tracked = 0, which JAX does not keep)

It is the inverse of zeroshotvideoclassification_tpu/models/porting.py:
_port_reference_sd: from_jax then _port_reference_sd gives back the trees.
Only numpy and torch are needed.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict

import numpy as np
import torch

# JAX stem sub-tree -> torchvision stem index
_STEM = {"conv1": "0", "bn1": "1", "conv2": "3", "bn2": "4"}
# JAX block sub-path -> torchvision block sub-module
_BLOCK = {
    "bn1": "conv1.1", "bn2": "conv2.1",
    "downsample/conv": "downsample.0", "downsample/bn": "downsample.1",
}
for _c in ("conv1", "conv2"):
    _BLOCK.update({f"{_c}/conv": f"{_c}.0", f"{_c}/conv_s": f"{_c}.0.0",
                   f"{_c}/bn_m": f"{_c}.0.1", f"{_c}/conv_t": f"{_c}.0.3"})
_HEAD = {"fc1": "output2emb_proj.layers.0", "fc2": "output2emb_proj.layers.1"}
_LEAF = {"w": "weight", "b": "bias", "scale": "weight", "bias": "bias",
         "mean": "running_mean", "var": "running_var"}


def flatten(tree, prefix: str = "") -> Dict[str, np.ndarray]:
    """Nested dicts -> {'a/b/c': array} (the checkpoint's key layout)."""
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, dict):
            out.update(flatten(v, key))
        else:
            out[key] = np.asarray(v)
    return out


def torch_key(path: str) -> str:
    """'backbone/layer1_0/conv1/conv_s/w' -> 'model.layer1.0.conv1.0.0.weight'
    (params and model_state paths alike); unknown paths raise ValueError."""
    parts = path.split("/")
    try:
        leaf = _LEAF[parts[-1]]
        if parts[0] == "head":
            return f"{_HEAD[parts[1]]}.{leaf}"
        if parts[0] == "backbone":
            if parts[1] == "stem":
                return f"model.stem.{_STEM[parts[2]]}.{leaf}"
            layer, block = parts[1].split("_")
            sub = _BLOCK["/".join(parts[2:-1])]
            return f"model.{layer}.{block}.{sub}.{leaf}"
    except (KeyError, IndexError, ValueError):
        pass
    raise ValueError(f"no counterpart in the port for JAX leaf {path!r} "
                     f"(ported: r2plus1d_18/r3d_18/mc3_18 + the mlp head)")


def _to_torch(path: str, a: np.ndarray) -> torch.Tensor:
    a = np.asarray(a, np.float32)
    if path.endswith("/w"):
        a = a.transpose(4, 3, 0, 1, 2) if a.ndim == 5 else a.T
    return torch.tensor(np.ascontiguousarray(a))  # a copy: JAX's are read-only


def from_flat(params: Dict[str, np.ndarray],
              model_state: Dict[str, np.ndarray]) -> "OrderedDict":
    """The same conversion from flat 'a/b/c' keyed dicts."""
    sd = OrderedDict()
    for flat in (params, model_state):
        for path, a in flat.items():
            key = torch_key(path)
            sd[key] = _to_torch(path, a)
            if key.endswith(".running_var"):
                sd[key[:-len("running_var")] + "num_batches_tracked"] = (
                    torch.zeros((), dtype=torch.long))
    return sd


def from_jax(params, model_state) -> "OrderedDict":
    """JAX (params, model_state) trees -> the port's state_dict (CPU,
    float32)."""
    return from_flat(flatten(params), flatten(model_state))
