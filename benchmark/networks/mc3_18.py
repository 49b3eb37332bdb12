"""MC3-18 (Tran et al., CVPR 2018; torchvision's mc3_18) with the fork's MLP
head, keys as torchvision's under `model.`: R3D-18 (r3d_18.py) with full
3x3x3 convs in stage 1 only; stages 2-4 take (1,3,3) convs of stride
(1,s,s) and a (1,s,s) downsample, so the clip keeps its frames after the
stem.
"""

from __future__ import annotations

from benchmark.networks import r3d_18

KINDS = (r3d_18.SIMPLE,) + (r3d_18.NO_TEMPORAL,) * 3

# the tests' clip shape on the CPU
TINY = {"clip_len": 4, "size": 32}


def describe(clip_len: int, size: int):
    """-> (convs, epilogues, linears) on one clip of clip_len x size x
    size."""
    return r3d_18.describe(clip_len, size, KINDS)


embed = r3d_18.embed
