"""The zero-shot model: a video backbone + an embedding head.

Counterpart of zeroshotvideoclassification_tpu/models/heads.py, all heads
in float32:

  * 'mlp'    the fork's head: clip-mean of the pooled backbone features ->
             Linear(f, f) -> ReLU -> Linear(f, 300) -> L2 normalize, f the
             backbone's feature_dim (512; X3D-M's 2048);
  * 'linear' the paper's head: clip-mean -> dropout 0.05 -> Linear(512,
             300) -> L2 normalize;
  * 'c3d'    relu(fc6) -> dropout 0.10 BEFORE the clip-mean ->
             Linear(4096, 300) -> L2 normalize (the C3D backbone's own).

clip_pool='embedding' runs the head on every clip, L2-normalizes, takes the
mean over clips and normalizes again (the C3D head ignores it; identical to
'feature' at one clip). fixconvs stops the gradient at the backbone's
pooled features (torch's requires_grad=False on the backbone, the JAX
package's stop_gradient): the backbone runs without autograd, its BN
running statistics still move in train mode. Dropout draws its mask from
the generator forward() is given (none: no dropout).

--tp N (models.heads.MLP.shard, as the JAX package's _tp_spec_for,
parallel/mesh.py:56-70): each process of a model group holds one shard of
the mlp head: fc1's output rows [m f/N, (m+1) f/N) and their biases (the
JAX column shard of fc1's [in, out] kernel), fc2's input columns of that
range (the row shard) and fc2's whole bias. The forward is
reduce_from_model(relu(fc1_m(copy_to_model(x))) @ fc2_m^T) + fc2's bias:
one model-group all-reduce after fc2, the bias added once after it. The
linear and C3D heads, and every backbone, are replicated.

Key names follow the reference (network.py:50-180, :481, :517): a
VideoResNet (or X3D-M, under PyTorchVideo's names) under `model.`, the mlp
head under
`output2emb_proj.layers.{0,1}`, the linear and C3D heads as `regressor`,
and C3D's layers (conv1 ... conv5b, fc6) at the TOP level, beside
`regressor`. So a reference checkpoint, c3d.pickle and the bridge from the
JAX package's pytrees line up with state_dict() key for key.
"""

from __future__ import annotations

import sys
from typing import Optional

import torch
from torch import nn

from zeroshotvideoclassification_tpu_torch.models import layers as L
from zeroshotvideoclassification_tpu_torch.models.c3d import C3D
from zeroshotvideoclassification_tpu_torch.models.resnet3d import (
    VideoResNet,
    mc3_18,
    r2plus1d_18,
    r3d_18,
)
from zeroshotvideoclassification_tpu_torch.models.x3d import X3D, x3d_m
from zeroshotvideoclassification_tpu_torch.parallel.multihost import (
    copy_to_model,
    reduce_from_model,
)

EMBED_DIM = 300
HEADS = ("mlp", "linear", "c3d")


def check_tp_width(width: int, tp: int) -> None:
    """ValueError where a 'model' axis of `tp` does not divide `width`, the
    outputs of fc1 that --tp shards (the JAX package's device_put of a
    sharding that does not divide a dimension raises ValueError too)."""
    if width % tp:
        raise ValueError(
            f"--tp {tp}: the mlp head's fc1 has {width} outputs, which a "
            f"'model' axis of {tp} does not divide (each process holds "
            f"{width} / {tp} of them)")


class MLP(nn.Module):
    """fc1 -> ReLU -> fc2, in float32; one shard of it under --tp
    (shard)."""

    # the tensors --tp shards -> the axis of torch's [out, in] layout split
    # over the model axis: fc1's rows (the JAX column shard of its [in,
    # out] kernel) and its bias, fc2's columns (the JAX row shard); fc2's
    # bias is whole on every process
    TP_AXES = {"layers.0.weight": 0, "layers.0.bias": 0,
               "layers.1.weight": 1}
    tp, index = 1, 0

    def __init__(self, dims=(512, 512, EMBED_DIM)):
        super().__init__()
        self.layers = nn.ModuleList(
            nn.Linear(a, b) for a, b in zip(dims[:-1], dims[1:]))

    def forward(self, x):
        if self.tp == 1:
            x = torch.relu(L.linear(x, self.layers[0]))
            return L.linear(x, self.layers[1])
        fc1, fc2 = self.layers
        h = torch.relu(L.linear(copy_to_model(x), fc1))
        return reduce_from_model(torch.matmul(h, fc2.weight.t())) + fc2.bias

    @torch.no_grad()
    def shard(self, tp: int, index: int) -> "MLP":
        """Keep shard `index` of `tp` of the whole head, in place: entries
        [index n, (index + 1) n) along TP_AXES, n = fc1's outputs / tp,
        each a parameter of its own, marked `model_parallel` (for
        train/step.sum_gradients). Once, on the whole head (the shards of
        bridge.shard_head)."""
        fc1, fc2 = self.layers
        check_tp_width(fc1.out_features, tp)
        if self.tp != 1:
            raise ValueError("the head is sharded already")
        n = fc1.out_features // tp
        for name, axis in self.TP_AXES.items():
            owner, leaf = name.rsplit(".", 1)
            module = self.get_submodule(owner)
            part = nn.Parameter(getattr(module, leaf).narrow(
                axis, index * n, n).clone())
            part.model_parallel = True
            setattr(module, leaf, part)
        fc1.out_features = fc2.in_features = n
        self.tp, self.index = int(tp), int(index)
        return self


class ZeroShotModel(nn.Module):
    """forward(x [B, nc, T, H, W, 3], generator=None) -> unit embeddings
    [B, 300] float32."""

    def __init__(self, backbone: nn.Module, head: str = "mlp",
                 fixconvs: bool = False, dropout_rate: float = 0.0,
                 clip_pool: str = "feature"):
        super().__init__()
        if head not in HEADS:
            raise ValueError(f"unknown head {head!r}")
        if isinstance(backbone, C3D):
            # the reference's layout: C3D's layers at the top level. They
            # are registered here; the backbone object keeps the same
            # modules and runs them
            for name, layer in backbone.named_children():
                self.add_module(name, layer)
            self.__dict__["_c3d"] = backbone
        else:
            self.model = backbone
        f = backbone.feature_dim
        if head == "mlp":
            self.output2emb_proj = MLP((f, f, EMBED_DIM))
        else:
            self.regressor = nn.Linear(f, EMBED_DIM)
        self.head = head
        self.fixconvs = bool(fixconvs)
        self.dropout_rate = float(dropout_rate)
        self.clip_pool = str(clip_pool)
        self.compute_dtype = torch.float32

    @property
    def backbone(self) -> nn.Module:
        return self.__dict__.get("_c3d") or self.model

    @property
    def tp(self):
        """(tp, this process's model index) of the head's shards; (1, 0)
        where it is whole or replicated."""
        head = getattr(self, "output2emb_proj", None)
        return (head.tp, head.index) if head is not None else (1, 0)

    def shard_head(self, tp: int, index: int) -> "ZeroShotModel":
        """--tp: keep shard `index` of `tp` of the mlp head (MLP.shard);
        the linear and C3D heads are replicated and stay whole. Before the
        optimizer is built: the shards are new parameters."""
        if self.head == "mlp" and tp > 1:
            self.output2emb_proj.shard(tp, index)
        return self

    def set_compute_dtype(self, dtype: torch.dtype,
                          masters: bool = False) -> "ZeroShotModel":
        """Convs (weights, C3D's biases and the input) run in `dtype`; BN
        parameters, C3D's fc6, the head and every reduction stay float32 —
        the JAX package's casts.

        Serving (masters=False) casts the conv weights once, in place.
        Training (masters=True) keeps them float32 and each conv casts a
        copy at every call (layers.Conv3d), so gradients and optimizer
        state are float32 (the JAX package's params, layers.py:66-67)."""
        for m in self.backbone.modules():
            if isinstance(m, L.Conv3d):
                m.compute_dtype = dtype if masters else None
                m.to(torch.float32 if masters else dtype)
        self.compute_dtype = dtype
        return self

    def forward(self, x, generator: Optional[torch.Generator] = None):
        b, nc = x.shape[0], x.shape[1]
        # [B*nc, T, H, W, 3] viewed as [B*nc, 3, T, H, W]: channels-last-3d
        # memory, so the first conv reads it without a copy
        x = x.reshape(b * nc, *x.shape[2:]).permute(0, 4, 1, 2, 3)
        with torch.set_grad_enabled(torch.is_grad_enabled()
                                    and not self.fixconvs):
            pooled = self.backbone(x.to(self.compute_dtype))
        if self.head == "c3d":
            feats = L.dropout(pooled, self.dropout_rate, generator,
                              self.training)
            emb = L.linear(feats.reshape(b, nc, -1).mean(dim=1),
                           self.regressor)
            return L.l2_normalize(emb)
        per_clip = self.clip_pool == "embedding"
        feats = pooled if per_clip else pooled.reshape(b, nc, -1).mean(dim=1)
        if self.head == "linear":
            feats = L.dropout(feats, self.dropout_rate, generator,
                              self.training)
            emb = L.linear(feats, self.regressor)
        else:
            emb = self.output2emb_proj(feats)
        if per_clip:
            emb = L.l2_normalize(emb).reshape(b, nc, -1).mean(dim=1)
        return L.l2_normalize(emb)


def routed_head(config) -> str:
    """The head get_network builds for `config` (without building it)."""
    name = config.network
    if "c3d" in name:
        return "c3d"
    if "resnet18" in name and not any(k in name for k in ("2plus1d", "mc3",
                                                          "r3d")):
        return "linear"
    return getattr(config, "head", "mlp")


def routed_backbone(config):
    """-> (class, builder) of the backbone get_network builds for `config`:
    'x3d_m' (X3D-M, models/x3d.py, which the JAX package does not have),
    then the JAX get_network's substring match on Config.network ('c3d',
    '2plus1d', 'mc3', 'r3d', then 'resnet18' -> an R3D-18)."""
    name = config.network
    if name == "x3d_m":
        return X3D, x3d_m
    for key, cls, build in (("c3d", C3D, C3D), ("2plus1d", VideoResNet,
                                                r2plus1d_18),
                            ("mc3", VideoResNet, mc3_18),
                            ("r3d", VideoResNet, r3d_18),
                            ("resnet18", VideoResNet, r3d_18)):
        if key in name:
            return cls, build
    raise ValueError(f"Network {name!r} not available!")


def check_tensor_parallel(config, tp: int) -> None:
    """ValueError where --tp `tp` cannot shard the head get_network builds
    for `config`: only the mlp head shards (over its backbone's feature
    width, 512 or X3D-M's 2048); the linear and C3D heads are replicated at
    any tp."""
    if tp > 1 and routed_head(config) == "mlp":
        check_tp_width(routed_backbone(config)[0].feature_dim, tp)


def get_network(config) -> ZeroShotModel:
    """Backbone (routed_backbone: x3d_m, whose published clip is --size
    224, c3d, r2plus1d_18, mc3_18, r3d_18, resnet18 -> an R3D-18 with the
    linear head) and head routing; C3D takes its own head and dropout 0.10,
    the linear head dropout 0.05.
    --remat ('none' / False mean off) applies to the VideoResNets and X3D-M
    (each block rematerialised); on C3D it changes nothing and says so on
    stderr."""
    name = config.network
    head = routed_head(config)
    dropout = 0.0
    remat = getattr(config, "remat", False)
    if str(remat) in ("False", "none", ""):
        remat = False  # before branching: 'none' is truthy
    mode = ("convs" if remat == "convs" else "full") if remat else False
    cls, build = routed_backbone(config)
    if cls is C3D:
        backbone, dropout = C3D(), 0.10
        if remat:
            print(f"WARNING: --remat {remat} has no effect on {name!r} "
                  f"(only the VideoResNet backbones rematerialize)",
                  file=sys.stderr)
    else:
        backbone = build(mode)
    if head == "linear":
        dropout = 0.05
    return ZeroShotModel(
        backbone, head, fixconvs=bool(getattr(config, "fixconvs", False)),
        dropout_rate=dropout,
        clip_pool=str(getattr(config, "clip_pool", "feature")))
