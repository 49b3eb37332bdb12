"""Pins of the yardstick: the seeded weights and the float32 reference's
embeddings of the measured networks, as they were before each network
became a file of its own. A change that moves a weight's draw or the
reference's forward fails here."""

import hashlib

import pytest
import torch

from benchmark.reference.models import Net
from benchmark.yardstick import weights

# sha256 over every tensor of weights.make(Net(name, 16, 112), 7, "cpu"),
# keys in sorted order, each key's bytes then the tensor's float32 bytes
WEIGHTS = {
    "r2plus1d_18": "9211b5e90a6536b77d3bd518cdb4eabf"
                   "3829a9887da22a2dd0d26048897c0394",
    "c3d": "3a7fbae976682302fb558121d6f4b18f"
           "e36704c31167ad05241f182096d785d6",
}

# (network, clip_len, size) -> (sum, sum of |e|, sum of e * (1 + index))
# of the train-mode reference embeddings of two seeded clips (C3D's head
# with its dropout); the sums move by about 1e-5 with the CPU's threads
EMBEDDINGS = {
    ("r2plus1d_18", 4, 32): (-0.6425970121053979, 27.301506717456505,
                              -711.3845228482969),
    ("c3d", 16, 32): (1.1567604298552396, 27.251523206846286,
                      259.1440775788551),
}


def _digest(params) -> str:
    h = hashlib.sha256()
    for k in sorted(params):
        h.update(k.encode())
        h.update(params[k].detach().contiguous().numpy().tobytes())
    return h.hexdigest()


@pytest.mark.parametrize("network", sorted(WEIGHTS))
def test_weights_keep_their_draw(network):
    params = weights.make(Net(network, 16, 112), 7, "cpu")
    assert _digest(params) == WEIGHTS[network]


@pytest.mark.parametrize("shape", sorted(EMBEDDINGS))
def test_reference_embeddings_keep_their_values(shape):
    network, clip_len, size = shape
    net = Net(network, clip_len, size)
    params = weights.make(net, 7, "cpu")
    g = torch.Generator().manual_seed(7)
    x = torch.rand((2, 1, clip_len, size, size, 3), generator=g) - 0.5
    with torch.no_grad():
        e = net.forward(params, x, train=True, dropout=(
            0.1, torch.Generator().manual_seed(8))).double()
    got = (float(e.sum()), float(e.abs().sum()),
           float((e.flatten() * torch.arange(1, e.numel() + 1)).sum()))
    assert got == pytest.approx(EMBEDDINGS[shape], rel=1e-4, abs=1e-3)
