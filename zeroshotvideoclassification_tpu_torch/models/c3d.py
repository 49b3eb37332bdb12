"""C3D (Tran et al., ICCV 2015) as an nn.Module.

Counterpart of zeroshotvideoclassification_tpu/models/c3d.py, with the same
architecture: 8 biased 3x3x3 convs (padding 1), each followed by ReLU, and 5
max pools (pool1 1x2x2, pools 2-5 2x2x2, pool5 with padding (0, 1, 1)), then
relu(fc6), 8192 -> 4096, in float32. fc7 and fc8 of the pretrained file
are bypassed by the reference's forward and are not created. No BN, so no
K2 epilogue runs here; the convs and pools are cuDNN's.

Modules carry the names of the reference and of c3d.pickle (conv1 ...
conv5b, fc6); models/heads.ZeroShotModel keeps them at the top level of its
state_dict, where the reference keeps them.

Input [N, 3, 16, 112, 112] in channels-last-3d memory (fc6 fixes the size);
forward returns the features [N, 4096] in float32. The flatten before fc6
is torch's NCDHW order (h.view(-1, 8192) in the reference; c3d.py:84-86),
taken over the LOGICAL shape of the pooled [N, 512, 1, 4, 4] map: its
channels-last memory is another order, which a flatten of the memory
would read without any error.
"""

from __future__ import annotations

import torch
from torch import nn

from zeroshotvideoclassification_tpu_torch.models import layers as L

CONVS = (  # name, cin, cout
    ("conv1", 3, 64),
    ("conv2", 64, 128),
    ("conv3a", 128, 256),
    ("conv3b", 256, 256),
    ("conv4a", 256, 512),
    ("conv4b", 512, 512),
    ("conv5a", 512, 512),
    ("conv5b", 512, 512),
)
# the pool after each conv that has one: window = stride, padding
_POOLS = {"conv1": ((1, 2, 2), 0), "conv2": (2, 0), "conv3b": (2, 0),
          "conv4b": (2, 0), "conv5b": (2, (0, 1, 1))}
FC6_IN = 8192


class C3D(nn.Module):
    feature_dim = 4096

    def __init__(self):
        super().__init__()
        for name, cin, cout in CONVS:
            self.add_module(name, L.conv3d(cin, cout, 3, 1, 1, bias=True))
        self.fc6 = nn.Linear(FC6_IN, self.feature_dim)

    def forward(self, x):
        h = x
        for name, _, _ in CONVS:
            h = torch.relu(getattr(self, name)(h))
            if name in _POOLS:
                window, pad = _POOLS[name]
                h = L.maxpool3d(h, window, window, pad)
        flat = h.float().reshape(h.shape[0], FC6_IN)  # NCDHW order
        return torch.relu(L.linear(flat, self.fc6))
