"""The pieces of a network's description: every conv and linear with its
shapes, and every BN epilogue, at a given clip shape. The FLOP count, the
K2 bound, the seeded weights and the plain reference read these lists;
none of them reads the program.

Each network is a file of its own, benchmark/networks/<name>.py, found by
its name (`network`); its `describe(clip_len, size)` walks its layers with
`_Walk` and returns (convs, epilogues, linears).
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

from benchmark import harness

# torchvision's VideoResNet: (channels, stride) of its four stages
STAGES = ((64, 1), (128, 2), (256, 2), (512, 2))
EMBED_DIM = 300


@dataclasses.dataclass(frozen=True)
class Conv:
    name: str          # the weight's key without ".weight"
    cin: int
    cout: int
    kernel: Tuple[int, int, int]
    stride: Tuple[int, int, int]
    padding: Tuple[int, int, int]
    bias: bool
    out_thw: Tuple[int, int, int]
    groups: int = 1    # cin and cout split into this many groups


@dataclasses.dataclass(frozen=True)
class Epilogue:
    name: str          # the BN's key prefix
    channels: int
    thw: Tuple[int, int, int]
    residual: bool
    relu: bool


@dataclasses.dataclass(frozen=True)
class Linear:
    name: str
    fin: int
    fout: int


def _triple(v):
    return tuple(v) if isinstance(v, (tuple, list)) else (v, v, v)


def _out(thw, k, s, p):
    return tuple((n + 2 * pp - kk) // ss + 1
                 for n, kk, ss, pp in zip(thw, k, s, p))


def midplanes(inplanes: int, planes: int) -> int:
    return (inplanes * planes * 3 * 3 * 3) // (inplanes * 3 * 3 + 3 * planes)


class _Walk:
    def __init__(self, thw):
        self.thw = tuple(thw)
        self.convs: List[Conv] = []
        self.epilogues: List[Epilogue] = []

    def conv(self, name, cin, cout, k, s, p, bias=False, thw=None,
             groups=1):
        k, s, p = _triple(k), _triple(s), _triple(p)
        out = _out(self.thw if thw is None else thw, k, s, p)
        self.convs.append(Conv(name, cin, cout, k, s, p, bias, out, groups))
        return out

    def bn(self, name, c, thw, residual=False, relu=True):
        self.epilogues.append(Epilogue(name, c, thw, residual, relu))


def mlp_head(features: int) -> List[Linear]:
    """The fork's MLP head: features -> features -> EMBED_DIM."""
    return [Linear("output2emb_proj.layers.0", features, features),
            Linear("output2emb_proj.layers.1", features, EMBED_DIM)]


def network(name: str, clip_len: int, size: int, root: str = harness.ROOT):
    """-> (convs, epilogues, linears) of a configuration's network and
    head, from benchmark/networks/<name>.py under `root`."""
    return harness.load_network(root, name).describe(clip_len, size)
