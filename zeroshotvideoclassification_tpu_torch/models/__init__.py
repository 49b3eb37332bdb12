"""Model layer: video ResNets, C3D, X3D-M and the zero-shot heads as
nn.Modules, and the weight bridge to and from the JAX package's pytrees."""

from zeroshotvideoclassification_tpu_torch.models.c3d import C3D
from zeroshotvideoclassification_tpu_torch.models.heads import (
    ZeroShotModel,
    get_network,
)
from zeroshotvideoclassification_tpu_torch.models.resnet3d import (
    VideoResNet,
    mc3_18,
    r2plus1d_18,
    r3d_18,
)
from zeroshotvideoclassification_tpu_torch.models.x3d import X3D, x3d_m
