"""The zero-shot model: a video backbone + the 'mlp' embedding head.

Counterpart of zeroshotvideoclassification_tpu/models/heads.py for the
'mlp' head with clip_pool='feature': the clip-mean of the pooled backbone
features -> Linear(512, 512) -> ReLU -> Linear(512, 300) -> L2 normalize,
all in float32. Key names follow the reference fork (network.py:481,517):
the backbone under `model.`, the head under `output2emb_proj.layers.{0,1}`,
so a reference checkpoint and the bridge from JAX pytrees line up with
state_dict() key for key. The 'linear' and C3D heads, clip_pool='embedding',
fixconvs and dropout are not ported yet (dropout is 0 on the ported
paths).
"""

from __future__ import annotations

import torch
from torch import nn

from zeroshotvideoclassification_tpu_torch.models import layers as L
from zeroshotvideoclassification_tpu_torch.models.resnet3d import (
    VideoResNet,
    mc3_18,
    r2plus1d_18,
    r3d_18,
)

EMBED_DIM = 300


class MLP(nn.Module):
    def __init__(self, dims=(512, 512, EMBED_DIM)):
        super().__init__()
        self.layers = nn.ModuleList(
            nn.Linear(a, b) for a, b in zip(dims[:-1], dims[1:]))

    def forward(self, x):
        x = torch.relu(L.linear(x, self.layers[0]))
        return L.linear(x, self.layers[1])


class ZeroShotModel(nn.Module):
    """forward(x [B, nc, T, H, W, 3]) -> unit embeddings [B, 300] float32."""

    def __init__(self, backbone: VideoResNet):
        super().__init__()
        self.model = backbone
        self.output2emb_proj = MLP((backbone.feature_dim,
                                    backbone.feature_dim, EMBED_DIM))
        self.compute_dtype = torch.float32

    def set_compute_dtype(self, dtype: torch.dtype,
                          masters: bool = False) -> "ZeroShotModel":
        """Convs (weights and input) run in `dtype`; BN parameters, the head
        and every reduction stay float32 — the JAX package's casts.

        Serving (masters=False) casts the conv weights once, in place.
        Training (masters=True) keeps them float32 and each conv casts a
        copy at every call (layers.Conv3d), so gradients and optimizer
        state are float32 (the JAX package's params, layers.py:66-67)."""
        for m in self.model.modules():
            if isinstance(m, L.Conv3d):
                m.compute_dtype = dtype if masters else None
                m.to(torch.float32 if masters else dtype)
        self.compute_dtype = dtype
        return self

    def forward(self, x):
        b, nc = x.shape[0], x.shape[1]
        # [B*nc, T, H, W, 3] viewed as [B*nc, 3, T, H, W]: channels-last-3d
        # memory, so the stem reads it without a copy
        x = x.reshape(b * nc, *x.shape[2:]).permute(0, 4, 1, 2, 3)
        pooled = self.model(x.to(self.compute_dtype))
        feats = pooled.reshape(b, nc, -1).mean(dim=1)
        return L.l2_normalize(self.output2emb_proj(feats))


def get_network(config) -> ZeroShotModel:
    """Backbone routing of the JAX get_network (substring match on
    Config.network) for the ported backbones and head."""
    name = config.network
    if "2plus1d" in name:
        backbone = r2plus1d_18()
    elif "mc3" in name:
        backbone = mc3_18()
    elif "r3d" in name:
        backbone = r3d_18()
    else:
        raise ValueError(f"network {name!r} is not ported (r2plus1d_18, "
                         f"r3d_18, mc3_18)")
    head = getattr(config, "head", "mlp")
    clip_pool = str(getattr(config, "clip_pool", "feature"))
    if head != "mlp" or clip_pool != "feature":
        raise ValueError(f"head {head!r} / clip_pool {clip_pool!r} is not "
                         f"ported (mlp / feature)")
    return ZeroShotModel(backbone)
