"""Read the JAX package's npz checkpoints into the port's model.

Counterpart of the read side of zeroshotvideoclassification_tpu/train/
checkpoint.py. The file is a flat npz: `params::<a/b/c>` and
`model_state::<a/b/c>` members (checkpoint.py:40-45,83-86), `__step__` and
a JSON `__meta__`. It is read with numpy alone, converted by models/bridge,
and loaded STRICTLY: every tensor the model holds must be present with a
matching shape, and every tensor of those two sections must belong to the
model, or ValueError (checkpoint.py:144-148) — a checkpoint of another
network must never end up serving a partly random model. The optimizer
section is not read. This is how a checkpoint trained on the TPU is served
on a GPU.
"""

from __future__ import annotations

import json
from typing import Dict

import numpy as np
from torch import nn

from zeroshotvideoclassification_tpu_torch.models import bridge


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


def load_checkpoint(path: str, model: nn.Module) -> dict:
    """Strict load of a JAX npz checkpoint into `model`; -> its metadata."""
    params, model_state, meta = read_checkpoint(path)
    try:
        sd = bridge.from_flat(params, model_state)
    except ValueError as e:
        raise ValueError(f"checkpoint {path!r} does not match the current "
                         f"model: {e}") from None
    want = model.state_dict()
    missing = [k for k in want if k not in sd]
    extra = [k for k in sd if k not in want]
    wrong = [k for k in want if k in sd and sd[k].shape != want[k].shape]
    if missing or extra or wrong:
        raise ValueError(
            f"checkpoint {path!r} does not match the current model: "
            f"{len(want) - len(missing) - len(wrong)}/{len(want)} tensors "
            f"restored (missing {missing[:3]}, unexpected {extra[:3]}, "
            f"wrong shape {wrong[:3]}; wrong --network/--head?)")
    model.load_state_dict(sd, strict=True)
    return meta
