"""Checkpoints of the port's training state in the JAX package's npz
layout, so that a checkpoint written by either package loads in the other.

Counterpart of zeroshotvideoclassification_tpu/train/checkpoint.py. The
file is a flat npz, read and written with numpy alone:

  params::<a/b/c>       the model's parameters and BN running statistics,
  model_state::<a/b/c>  in the JAX layouts and paths that models/bridge
                        builds (num_batches_tracked, which JAX does not
                        keep, is not written)
  opt_state::<key>      the guarded Adam's state, under the keys and dtypes
                        that the JAX package's _flatten gives its
                        make_optimizer state (optax.inject_hyperparams over
                        an ApplyIfFiniteState over optax.adam's chain):
      count                                       int32
      hyperparams/learning_rate                   float32
      inner_state/notfinite_count                 int32
      inner_state/last_finite                     bool
      inner_state/total_notfinite                 int32
      inner_state/inner_state/0/count             int32
      inner_state/inner_state/0/{mu,nu}/<a/b/c>   float32, as the params
  __step__              int32: train steps taken, skipped ones included
  __meta__              JSON: epoch, accuracy and the run's config

The two counts. `count` is inject_hyperparams' count of every update, a
skipped one too; `inner_state/inner_state/0/count` is Adam's, which a
skipped step leaves alone, as it leaves GuardedAdam.count. The port keeps
Adam's count and total_notfinite, and writes `count` as their sum: the
number of updates of a state that started from zero, since every update
is either finite (Adam's count moves) or not (total_notfinite moves).
tests/test_torch_checkpoint.py holds it to the JAX package's after steps
with a NaN step among them. On reading, `count` is checked like every
leaf and then dropped: the sum gives it back.

Under --tp the file holds the mlp head and its moments whole, as the JAX
package's does: host_state gathers the head's shards over the model group
(a collective of the group's processes, which all call it; process 0
writes), and load_checkpoint and warm_start read the whole tensors and
copy this process's shard of them (bridge.shard_head) into the model's
parameters and the optimizer's moments, in place.

Writes are atomic (a temporary file, then os.replace). Loads are STRICT
for the sections named: every tensor the model (and optimizer) holds must
be present with its shape, or ValueError, and nothing is changed; tensors
of the file that the model does not hold are ignored, as in the JAX
package. warm_start is the deliberately partial load. This is also how a
checkpoint trained on the TPU is served on a GPU (cli/infer.load_model).
"""

from __future__ import annotations

import json
import os
import tempfile
from typing import Dict, Iterable, Optional

import numpy as np
import torch
from torch import nn

from zeroshotvideoclassification_tpu_torch.models import bridge
from zeroshotvideoclassification_tpu_torch.parallel.multihost import (
    gather_model,
)

SECTIONS = ("params", "model_state", "opt_state")
_ADAM = "inner_state/inner_state/0"
_SCALARS = {  # opt_state key -> dtype
    "count": np.int32,
    "hyperparams/learning_rate": np.float32,
    "inner_state/notfinite_count": np.int32,
    "inner_state/last_finite": np.bool_,
    "inner_state/total_notfinite": np.int32,
    f"{_ADAM}/count": np.int32,
}


def read_checkpoint(path: str):
    """-> (params, model_state, meta): flat 'a/b/c' -> numpy dicts and the
    metadata."""
    with np.load(path, allow_pickle=False) as data:
        meta = json.loads(str(data["__meta__"]))
        sections: Dict[str, Dict[str, np.ndarray]] = {
            "params": {}, "model_state": {}}
        for k in data.files:
            sec, sep, key = k.partition("::")
            if sep and sec in sections:
                sections[sec][key] = data[k]
    return sections["params"], sections["model_state"], meta


def read_meta(path: str) -> Dict:
    """Checkpoint metadata (epoch, accuracy, config) without the tensors."""
    with np.load(path, allow_pickle=False) as data:
        return json.loads(str(data["__meta__"]))


def _copies(tree) -> Dict[str, np.ndarray]:
    """bridge.flatten with every array an owned float32 copy (bridge's
    arrays may share memory with CPU tensors that training goes on
    changing)."""
    return {k: np.array(v, np.float32)
            for k, v in bridge.flatten(tree).items()}


def _whole(model: nn.Module, state_dict) -> Dict[str, torch.Tensor]:
    """`state_dict` (of `model`'s keys) with the mlp head's shards gathered
    whole over the model group (parallel.multihost.gather_model: every
    member calls it); as it is where the head is whole."""
    if getattr(model, "tp", (1, 0))[0] == 1:
        return state_dict
    return {k: (gather_model(v, bridge.TP_AXES[k]) if k in bridge.TP_AXES
                else v) for k, v in state_dict.items()}


def _shard(model: nn.Module, key: str, t: torch.Tensor) -> torch.Tensor:
    """This process's shard of the whole tensor `t` of `key` (t itself
    where the model's head is whole)."""
    return bridge.shard_head({key: t}, *getattr(model, "tp", (1, 0)))[key]


def _opt_flat(model: nn.Module, optimizer) -> Dict[str, np.ndarray]:
    """The guarded Adam's state under the JAX package's opt_state keys."""
    mu, nu, adam_count = bridge.adam_to_jax(
        model, optimizer, whole=lambda sd: _whole(model, sd))
    skipped = int(optimizer.total_notfinite)
    flat = {
        "count": adam_count + skipped,  # every update: finite + skipped
        "hyperparams/learning_rate": optimizer.param_groups[0]["lr"],
        "inner_state/notfinite_count": int(optimizer.notfinite_count),
        "inner_state/last_finite": bool(optimizer.last_finite),
        "inner_state/total_notfinite": skipped,
        f"{_ADAM}/count": adam_count,
    }
    out = {k: np.asarray(v, _SCALARS[k]) for k, v in flat.items()}
    for name, tree in (("mu", mu), ("nu", nu)):
        for k, v in _copies(tree).items():
            out[f"{_ADAM}/{name}/{k}"] = v
    return out


def host_state(state) -> Dict[str, np.ndarray]:
    """A TrainState (train/step.py) as the npz members a checkpoint holds,
    host numpy copies (a device state waits for the device here): what
    save_checkpoint writes and AsyncCheckpointer.submit takes. Under --tp
    every process of the model group calls it (the head is gathered
    whole) and each gets the same members."""
    params, model_state = bridge.to_jax(_whole(state.model,
                                                state.model.state_dict()))
    payload = {}
    for section, flat in (("params", _copies(params)),
                          ("model_state", _copies(model_state)),
                          ("opt_state", _opt_flat(state.model,
                                                  state.optimizer))):
        for k, v in flat.items():
            payload[f"{section}::{k}"] = v
    payload["__step__"] = np.asarray(state.step, np.int32)
    return payload


def save_checkpoint(path: str, state, epoch: int, accuracy: float,
                    config_json: Optional[str] = None) -> None:
    """Atomic write of the full train state: `state` is a TrainState or
    what host_state made of one."""
    payload = state if isinstance(state, dict) else host_state(state)
    meta = {"epoch": epoch, "accuracy": float(accuracy)}
    if config_json:
        meta["config"] = json.loads(config_json)
    where = os.path.dirname(path) or "."
    os.makedirs(where, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=where, suffix=".npz.tmp")
    os.close(fd)
    try:
        with open(tmp, "wb") as f:
            np.savez(f, __meta__=json.dumps(meta), **payload)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _model_leaves(model: nn.Module):
    """{section: {jax path: state_dict key}} of the model's tensors."""
    out = {"params": {}, "model_state": {}}
    for key in model.state_dict():
        found = bridge.jax_path(key)
        if found is not None:
            out[found[0]][found[1]] = key
    return out


def _opt_leaves(model: nn.Module):
    """{opt_state key: (parameter key, its jax path)}, (None, None) for
    the scalars."""
    out = {k: (None, None) for k in _SCALARS}
    for key, p in model.named_parameters():
        path = bridge.jax_path(key)[1]
        for name in ("mu", "nu"):
            out[f"{_ADAM}/{name}/{path}"] = (key, path)
    return out


def load_checkpoint(path: str, model: nn.Module, optimizer=None,
                    strict_sections: Optional[Iterable[str]] = None,
                    load_sections: Optional[Iterable[str]] = None) -> dict:
    """Restore `model` (parameters and BN running statistics) and, given
    it, `optimizer` (a GuardedAdam of the model's parameters: moments,
    counters, learning rate) from a checkpoint of either package; -> its
    metadata, with the step count (`__step__`) under "step".

    `load_sections` names the sections read at all (default: params and
    model_state, and opt_state with an optimizer); `strict_sections` those
    in which every tensor must be present with its shape (default: all that
    are read), else ValueError and nothing changes. Evaluation passes
    strict_sections=("params", "model_state"), as the JAX package does."""
    if load_sections is None:
        load_sections = SECTIONS if optimizer is not None else SECTIONS[:2]
    load_sections = tuple(load_sections)
    strict_sections = (load_sections if strict_sections is None
                       else tuple(strict_sections))
    missing = set(strict_sections) - set(load_sections)
    if missing:
        raise ValueError(f"strict_sections {sorted(missing)} are not in "
                         f"load_sections — they could never be verified")
    if "opt_state" in load_sections and optimizer is None:
        raise ValueError("loading opt_state needs the optimizer")
    with np.load(path, allow_pickle=False) as data:
        meta = json.loads(str(data["__meta__"]))
        meta["step"] = int(data["__step__"])
        flat = {sec: {} for sec in load_sections}
        for k in data.files:
            sec, sep, key = k.partition("::")
            if sep and sec in flat:
                flat[sec][key] = data[k]

    def refuse(sec, loaded, total):
        raise ValueError(
            f"checkpoint {path!r} does not match the current model: only "
            f"{loaded}/{total} {sec} tensors restored (wrong --network/"
            f"--head?). Use --weights for a partial warm start.")

    want = model.state_dict()
    new_sd = {}
    for sec, leaves in _model_leaves(model).items():
        if sec not in flat:
            continue
        got = {}
        for jpath, key in leaves.items():
            a = flat[sec].get(jpath)
            if a is not None:
                t = _shard(model, key, bridge.from_flat({jpath: a}, {})[key])
                if t.shape == want[key].shape:
                    got[key] = t
        if len(got) != len(leaves) and sec in strict_sections:
            refuse(sec, len(got), len(leaves))
        new_sd.update(got)
    opt_new = {}
    if "opt_state" in flat:
        params = dict(model.named_parameters())
        for k, (key, jpath) in _opt_leaves(model).items():
            a = flat["opt_state"].get(k)
            if a is None:
                continue
            if key is None:
                if a.shape == ():
                    opt_new[k] = a
            else:
                t = _shard(model, key, bridge.from_flat({jpath: a}, {})[key])
                if t.shape == params[key].shape:
                    opt_new[k] = t
        total = len(_opt_leaves(model))
        if len(opt_new) != total and "opt_state" in strict_sections:
            refuse("opt_state", len(opt_new), total)
    for key in [k for k in new_sd if k.endswith(".running_var")]:
        # JAX keeps no count of BN updates: a loaded BN starts it at 0
        new_sd[key[:-len("running_var")] + "num_batches_tracked"] = (
            torch.zeros((), dtype=torch.long))
    model.load_state_dict(new_sd, strict=False)
    if opt_new:
        _restore_optimizer(model, optimizer, opt_new)
    return meta


@torch.no_grad()
def _restore_optimizer(model, optimizer, flat) -> None:
    """Write opt_state values (scalars as numpy, moments as tensors keyed
    by opt_state key) into the guarded Adam, in place where it has state;
    new moments keep their parameter's memory layout."""
    from zeroshotvideoclassification_tpu_torch.train.optimizer import set_lr

    for k, target in (("inner_state/notfinite_count",
                       optimizer.notfinite_count),
                      ("inner_state/total_notfinite",
                       optimizer.total_notfinite),
                      ("inner_state/last_finite", optimizer.last_finite),
                      (f"{_ADAM}/count", optimizer.count)):
        if k in flat:
            target.fill_(flat[k].item())
    if "hyperparams/learning_rate" in flat:
        set_lr(optimizer, float(flat["hyperparams/learning_rate"]))
    for key, p in model.named_parameters():
        path = bridge.jax_path(key)[1]
        st = optimizer.state[p]
        for name, slot in (("mu", "exp_avg"), ("nu", "exp_avg_sq")):
            t = flat.get(f"{_ADAM}/{name}/{path}")
            if t is None:
                continue
            if slot not in st:
                st[slot] = torch.zeros_like(p)
            st[slot].copy_(t)
        if st:
            st["step"] = optimizer.count
            for slot in ("exp_avg", "exp_avg_sq"):
                if slot not in st:
                    st[slot] = torch.zeros_like(p)


def _torch_source(path: str) -> Dict[str, torch.Tensor]:
    """A .pth / .pth.tar / .pickle file -> {port state_dict key: tensor},
    its kind told from its keys as the JAX package's
    porting.detect_source_kind does: the reference fork's
    checkpoint.pth.tar ({'state_dict', 'opt', 'accuracy'} with DataParallel
    `module.` prefixes; its keys are the port's already), C3D's c3d.pickle
    (DavideA/c3d-pytorch: conv1 ... fc8 at the top level, the port's C3D
    keys; fc7 and fc8, which the reference's forward bypasses, skipped), or
    a torchvision video-resnet state_dict (backbone keys, which the port
    holds under `model.`; the classifier `fc.*` skipped). Read with
    torch.load(weights_only=True), which admits the argparse Namespace the
    reference stores beside the weights and refuses any other object."""
    import argparse

    with torch.serialization.safe_globals([argparse.Namespace]):
        obj = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(obj, dict) and "state_dict" in obj:
        obj = obj["state_dict"]
    sd = {(k[len("module."):] if k.startswith("module.") else k): v
          for k, v in obj.items() if isinstance(v, torch.Tensor)}
    reference = any(k.startswith(("model.", "output2emb_proj.",
                                  "regressor.")) for k in sd)
    if reference:
        return sd
    if "conv5b.weight" in sd or ("conv1.weight" in sd and "fc6.weight" in sd):
        return {k: v for k, v in sd.items()
                if not k.startswith(("fc7.", "fc8."))}
    return {f"model.{k}": v for k, v in sd.items()
            if not k.startswith("fc.")}


def warm_start(path: str, model: nn.Module) -> int:
    """Non-strict partial load (--weights, the reference's main.py:114-124:
    intersect keys, update, keep the rest): every tensor of the file whose
    key and shape the model has, BN running statistics included, from a
    checkpoint npz of either package or a torch source (.pth / .pth.tar /
    .pickle: torchvision video-resnet weights, the reference fork's
    checkpoint, or C3D's c3d.pickle). -> the number of tensors loaded
    (num_batches_tracked, which the JAX package does not keep, is neither
    loaded nor counted)."""
    if path.endswith((".pth", ".pth.tar", ".pickle", ".pkl")):
        sd = _torch_source(path)
    else:
        params, model_state, _ = read_checkpoint(path)
        sd = {}
        for flat in (params, model_state):
            for jpath, a in flat.items():
                try:
                    sd.update(bridge.from_flat({jpath: a}, {}))
                except ValueError:  # a leaf the port's models do not have
                    continue
    sd = bridge.shard_head(sd, *getattr(model, "tp", (1, 0)))
    want = model.state_dict()
    take = {k: v for k, v in sd.items()
            if k in want and not k.endswith("num_batches_tracked")
            and tuple(v.shape) == tuple(want[k].shape)}
    model.load_state_dict(take, strict=False)
    return len(take)
