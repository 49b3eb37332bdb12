"""Model layer: video ResNets and the zero-shot head as nn.Modules, and the
weight bridge to and from the JAX package's pytrees."""

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
