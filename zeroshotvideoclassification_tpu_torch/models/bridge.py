"""Weights across the frameworks: JAX pytrees <-> the port's state_dict.

from_jax(params, model_state) turns the JAX package's ZeroShotModel trees
(nested dicts of numpy arrays, as ZeroShotModel.init returns them or a
checkpoint stores them) into a state_dict for models.heads.ZeroShotModel:

  conv weights   DHWIO -> OIDHW
  linear weights [in, out] -> [out, in]
  BN             scale/bias/mean/var -> weight/bias/running_mean/running_var
                 (+ num_batches_tracked = 0, which JAX does not keep)

It is the inverse of zeroshotvideoclassification_tpu/models/porting.py:
_port_reference_sd: from_jax then _port_reference_sd gives back the trees.
to_jax(state_dict) is the way back, (params, model_state) as nested dicts of
numpy arrays, so that parameters and BN statistics after some training steps
can be compared leaf by leaf. adam_from_jax / adam_to_jax carry Adam's
moments and count across (optax's mu / nu / count <-> exp_avg / exp_avg_sq /
step of train/optimizer.GuardedAdam), in the same layouts as the parameters.
conv_weight_from_jax / conv_weight_to_jax carry one conv weight across, e.g.
the temporal conv op's (ops/temporal_conv.temporal_conv3 takes the JAX
layout [3, 1, 1, Ci, Co]; a Conv3d holds [Co, Ci, 3, 1, 1]).
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


def conv_weight_from_jax(w) -> torch.Tensor:
    """A JAX conv weight [D, H, W, Ci, Co] (DHWIO) -> a Conv3d weight
    [Co, Ci, D, H, W] (OIDHW), float32, a contiguous copy."""
    a = np.asarray(w, np.float32)
    if a.ndim != 5:
        raise ValueError(f"a DHWIO conv weight has 5 axes, got {a.shape}")
    return torch.tensor(np.ascontiguousarray(a.transpose(4, 3, 0, 1, 2)))


def conv_weight_to_jax(w: torch.Tensor) -> np.ndarray:
    """A Conv3d weight [Co, Ci, D, H, W] -> the JAX layout [D, H, W, Ci, Co],
    a contiguous float32 numpy array."""
    if w.dim() != 5:
        raise ValueError(f"an OIDHW conv weight has 5 axes, got "
                         f"{tuple(w.shape)}")
    a = w.detach().float().cpu().numpy()
    return np.ascontiguousarray(a.transpose(2, 3, 4, 1, 0))


def _to_torch(path: str, a: np.ndarray) -> torch.Tensor:
    a = np.asarray(a, np.float32)
    if path.endswith("/w"):
        if a.ndim == 5:
            return conv_weight_from_jax(a)
        a = a.T
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


_STEM_INV = {v: k for k, v in _STEM.items()}
_BLOCK_INV = {v: k for k, v in _BLOCK.items()}
_HEAD_INV = {v: k for k, v in _HEAD.items()}


def jax_path(key: str):
    """'model.layer1.0.conv1.0.0.weight' -> ('params',
    'backbone/layer1_0/conv1/conv_s/w'): the inverse of torch_key, with the
    tree ('params' or 'model_state') the leaf lives in; None for
    num_batches_tracked, which JAX does not keep."""
    mod, _, leaf = key.rpartition(".")
    if leaf == "num_batches_tracked":
        return None
    try:
        if mod in _HEAD_INV:
            return "params", f"head/{_HEAD_INV[mod]}/{'w' if leaf == 'weight' else 'b'}"
        parts = mod.split(".")
        if parts[0] == "model":
            if parts[1] == "stem":
                sub, where = _STEM_INV[parts[2]], "backbone/stem"
            else:
                sub = _BLOCK_INV[".".join(parts[3:])]
                where = f"backbone/{parts[1]}_{parts[2]}"
            if sub.rpartition("/")[2].startswith("bn"):
                tree, name = {
                    "weight": ("params", "scale"), "bias": ("params", "bias"),
                    "running_mean": ("model_state", "mean"),
                    "running_var": ("model_state", "var")}[leaf]
            else:
                tree, name = "params", {"weight": "w"}[leaf]
            return tree, f"{where}/{sub}/{name}"
    except (KeyError, IndexError):
        pass
    raise ValueError(f"no counterpart in the JAX package for {key!r}")


def to_jax(state_dict):
    """The port's state_dict -> (params, model_state) nested dicts of float32
    numpy arrays in the JAX package's layouts (conv OIDHW -> DHWIO, linear
    [out, in] -> [in, out])."""
    trees = {"params": {}, "model_state": {}}
    for key, t in state_dict.items():
        found = jax_path(key)
        if found is None:
            continue
        tree, path = found
        if path.endswith("/w") and t.dim() == 5:
            a = conv_weight_to_jax(t)
        else:
            a = t.detach().float().cpu().numpy()
            if path.endswith("/w"):
                a = a.T
        node = trees[tree]
        *dirs, name = path.split("/")
        for d in dirs:
            node = node.setdefault(d, {})
        node[name] = np.ascontiguousarray(a)
    return trees["params"], trees["model_state"]


def adam_from_jax(model, optimizer, mu, nu, count: int) -> None:
    """Load optax Adam moments (trees shaped like the JAX params) and its
    count into `optimizer`, whose parameters are `model`'s."""
    m_sd = from_flat(flatten(mu), {})
    v_sd = from_flat(flatten(nu), {})
    with torch.no_grad():
        optimizer.count.fill_(int(count))
        for key, p in model.named_parameters():
            st = optimizer.state[p]
            st["step"] = optimizer.count
            st["exp_avg"] = m_sd[key].to(p.device)
            st["exp_avg_sq"] = v_sd[key].to(p.device)


def adam_to_jax(model, optimizer):
    """-> (mu, nu, count): `optimizer`'s moments as trees in the JAX
    package's layouts (zeros for a parameter that has not stepped yet, as
    optax.adam's init), and its step count."""
    named = dict(model.named_parameters())

    def moments(slot):
        return to_jax({k: (optimizer.state[p][slot] if p in optimizer.state
                           else torch.zeros_like(p))
                       for k, p in named.items()})[0]

    return moments("exp_avg"), moments("exp_avg_sq"), int(optimizer.count)
