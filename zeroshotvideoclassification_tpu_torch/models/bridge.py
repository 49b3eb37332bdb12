"""Weights across the frameworks: JAX pytrees <-> the port's state_dict.

from_jax(params, model_state) turns the JAX package's ZeroShotModel trees
(nested dicts of numpy arrays, as ZeroShotModel.init returns them or a
checkpoint stores them) into a state_dict for models.heads.ZeroShotModel:

  conv weights   DHWIO -> OIDHW
  linear weights [in, out] -> [out, in]
  BN             scale/bias/mean/var -> weight/bias/running_mean/running_var
                 (+ num_batches_tracked = 0, which JAX does not keep)

The keys are the reference's, as porting.py reads them: a VideoResNet
under `model.`, C3D's conv1 ... conv5b and fc6 (weights and biases) at the
top level, the heads as `output2emb_proj.layers.{0,1}` or `regressor`. fc6
crosses as a plain transpose: both packages flatten its input in NCDHW
order. It is the inverse of zeroshotvideoclassification_tpu/models/
porting.py:_port_reference_sd: from_jax then _port_reference_sd gives back
the trees. X3D-M (`model.blocks.`) has no counterpart in the JAX package:
its leaves cross as `backbone/x3d/<its module path>/<torch leaf name>` in
the port's own layouts (OIDHW convs), running statistics in model_state,
so that the port's checkpoints hold it.
to_jax(state_dict) is the way back, (params, model_state) as nested dicts of
numpy arrays, so that parameters and BN statistics after some training steps
can be compared leaf by leaf. adam_from_jax / adam_to_jax carry Adam's
moments and count across (optax's mu / nu / count <-> exp_avg / exp_avg_sq /
step of train/optimizer.GuardedAdam), in the same layouts as the parameters.
shard_head(state_dict, tp, m) keeps what process m of a model group of
--tp holds of the mlp head (fc1's output rows and bias entries of its
range, fc2's input columns of it, fc2's bias whole: the JAX package's
column and row shards in torch's [out, in] layout); unshard_head is its
inverse, a concatenation of the tp shards, bit for bit. A whole JAX tree
goes through from_jax, then shard_head; adam_from_jax shards Adam's
moments by the model's own head (ZeroShotModel.tp) the same way.
conv_weight_from_jax / conv_weight_to_jax carry one conv weight across, e.g.
the temporal conv op's (ops/temporal_conv.temporal_conv3 takes the JAX
layout [3, 1, 1, Ci, Co]; a Conv3d holds [Co, Ci, 3, 1, 1]).
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict

import numpy as np
import torch

from zeroshotvideoclassification_tpu_torch.models.c3d import CONVS
from zeroshotvideoclassification_tpu_torch.models.heads import MLP

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
_HEAD = {"fc1": "output2emb_proj.layers.0", "fc2": "output2emb_proj.layers.1",
         "regressor": "regressor"}
# the mlp head's tensors that --tp shards (models/heads.MLP.TP_AXES) ->
# the axis split over the model axis
TP_AXES = {f"output2emb_proj.{k}": axis for k, axis in MLP.TP_AXES.items()}
# C3D's layers, the same names in both packages
_C3D = tuple(name for name, _, _ in CONVS) + ("fc6",)
# X3D-M's leaves, which only the port has, under backbone/<this>/
X3D_PATH = "x3d"
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
    if parts[:2] == ["backbone", X3D_PATH] and len(parts) > 3:
        return "model." + ".".join(parts[2:])
    try:
        leaf = _LEAF[parts[-1]]
        if parts[0] == "head":
            return f"{_HEAD[parts[1]]}.{leaf}"
        if parts[0] == "backbone":
            if parts[1] in _C3D and len(parts) == 3:
                return f"{parts[1]}.{leaf}"
            if parts[1] == "stem":
                return f"model.stem.{_STEM[parts[2]]}.{leaf}"
            layer, block = parts[1].split("_")
            sub = _BLOCK["/".join(parts[2:-1])]
            return f"model.{layer}.{block}.{sub}.{leaf}"
    except (KeyError, IndexError, ValueError):
        pass
    raise ValueError(f"no counterpart in the port for JAX leaf {path!r} "
                     f"(ported: r2plus1d_18/r3d_18/mc3_18/c3d + the mlp, "
                     f"linear and c3d heads)")


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
    if mod.startswith("model.blocks."):
        tree = "model_state" if leaf.startswith("running_") else "params"
        return tree, f"backbone/{X3D_PATH}/" + key[len("model."):].replace(
            ".", "/")
    try:
        wb = {"weight": "w", "bias": "b"}[leaf] if leaf in (
            "weight", "bias") else None
        if mod in _HEAD_INV:
            return "params", f"head/{_HEAD_INV[mod]}/{wb}"
        if mod in _C3D and wb:
            return "params", f"backbone/{mod}/{wb}"
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


def shard_head(state_dict, tp: int, m: int) -> "OrderedDict":
    """The entries of `state_dict` (the port's keys, whole tensors) as
    process `m` of a model group of `tp` holds them: the mlp head's
    TP_AXES tensors narrowed to shard m (contiguous copies), everything
    else as it is. tp 1: the same entries."""
    out = OrderedDict(state_dict)
    if tp == 1:
        return out
    for key, axis in TP_AXES.items():
        if key in out:
            t = out[key]
            n, rem = divmod(t.shape[axis], tp)
            if rem:
                raise ValueError(f"{key}: {t.shape[axis]} entries on axis "
                                 f"{axis} do not split over {tp} shards")
            out[key] = t.narrow(axis, m * n, n).contiguous()
    return out


def unshard_head(shards) -> "OrderedDict":
    """The inverse of shard_head: the tp shards' state dicts (in model-index
    order) -> one with the head's TP_AXES tensors whole (concatenated) and
    every other entry from the first shard."""
    out = OrderedDict(shards[0])
    if len(shards) > 1:
        for key, axis in TP_AXES.items():
            if key in out:
                out[key] = torch.cat([s[key] for s in shards], dim=axis)
    return out


def adam_from_jax(model, optimizer, mu, nu, count: int) -> None:
    """Load optax Adam moments (trees shaped like the JAX params, whole)
    and its count into `optimizer`, whose parameters are `model`'s; a
    sharded head takes its shard of them (shard_head)."""
    tp = getattr(model, "tp", (1, 0))
    m_sd = shard_head(from_flat(flatten(mu), {}), *tp)
    v_sd = shard_head(from_flat(flatten(nu), {}), *tp)
    with torch.no_grad():
        optimizer.count.fill_(int(count))
        for key, p in model.named_parameters():
            st = optimizer.state[p]
            st["step"] = optimizer.count
            st["exp_avg"] = m_sd[key].to(p.device)
            st["exp_avg_sq"] = v_sd[key].to(p.device)


def adam_to_jax(model, optimizer, whole=None):
    """-> (mu, nu, count): `optimizer`'s moments as trees in the JAX
    package's layouts (zeros for a parameter that has not stepped yet, as
    optax.adam's init), and its step count. `whole` ({key: moment} ->
    the same with the head's shards made whole, as the checkpoint's
    model-group gather does) is applied before the layouts change; without
    it a sharded head gives its shards."""
    named = dict(model.named_parameters())

    def moment(p, slot):  # zeros where Adam never stepped (--fixconvs)
        t = optimizer.state.get(p, {}).get(slot)
        return torch.zeros_like(p) if t is None else t

    def moments(slot):
        sd = {k: moment(p, slot) for k, p in named.items()}
        return to_jax(sd if whole is None else whole(sd))[0]

    return moments("exp_avg"), moments("exp_avg_sq"), int(optimizer.count)
