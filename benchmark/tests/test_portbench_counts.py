"""The frozen FLOP count against torch.utils.flop_counter on the port's
models at small clip shapes, and the frozen bound arithmetic against the
numbers it was copied with."""

import math

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark.yardstick import arch, counts


def _port_model(network, clip_len, size):
    from zeroshotvideoclassification_tpu_torch.config import Config
    from zeroshotvideoclassification_tpu_torch.models import get_network

    model = get_network(Config(network=network, clip_len=clip_len,
                               size=size)).eval()
    return model


@pytest.mark.parametrize("network,clip_len,size,clips", [
    ("r2plus1d_18", 4, 32, 2),
    ("r2plus1d_18", 8, 64, 1),
    ("c3d", 16, 112, 1),
])
def test_forward_flops_match_flop_counter(network, clip_len, size, clips):
    model = _port_model(network, clip_len, size)
    x = torch.zeros(clips, 1, clip_len, size, size, 3)
    with torch.no_grad(), FlopCounterMode(display=False) as fc:
        model(x)
    convs, _, linears = arch.network(network, clip_len, size)
    assert counts.forward_flops(convs, linears, clips) == fc.get_total_flops()


def test_published_counts():
    convs, epis, lins = arch.network("r2plus1d_18", 16, 112)
    assert len(convs) == 37 and len(epis) == 37
    assert sum(e.residual for e in epis) == 8
    assert counts.forward_flops(convs, lins, 1) == 81038583808
    convs, epis, lins = arch.network("c3d", 16, 112)
    assert not epis and counts.forward_flops(convs, lins, 1) == 77062832128
    assert counts.train_flops(convs, lins, 2) == 6 * 77062832128


def test_epilogue_bytes_and_bound():
    # PERF.md's K2 rows at 16 clips, bf16: 4.30 GB forward, 8.29 GB back
    _, epis, _ = arch.network("r2plus1d_18", 16, 112)
    fwd = sum(counts.epilogue_bytes_flops((16, *e.thw, e.channels), 2,
                                          e.residual, e.relu, False)[0]
              for e in epis)
    bwd = sum(counts.epilogue_bytes_flops((16, *e.thw, e.channels), 2,
                                          e.residual, e.relu, True)[0]
              for e in epis)
    assert round(fwd / 1e9, 2) == 4.30 and round(bwd / 1e9, 2) == 8.29
    bound = counts.k2_step_bound_seconds(epis, 16)
    assert math.isclose(bound, (fwd + bwd) / counts.HBM_BYTES_PER_S)
    assert math.isclose(bound * 1e3, 1.2833 + 2.4750, rel_tol=1e-3)
    # a kernel bound by its operations
    assert counts.bound_seconds(1.0, 67e12) == 1.0
    assert counts.bound_seconds(3.35e12, 1.0) == 1.0
    nbytes, flops = counts.epilogue_bytes_flops((10, 3), 4, True, True, True)
    assert (nbytes, flops) == (30 * 4 * 5, 30 * 8)


def test_kinds():
    assert counts.kind("void bn_bwd_kernel<bf16>") == "K2 backward"
    assert counts.kind("bn_apply_relu_kernel") == "K2 forward"
    assert counts.kind("video_transform_kernel<1>") == "K1"
    assert counts.kind("ncclDevKernel_AllReduce_Sum_f32") == "NCCL"
    assert counts.kind("sm90_xmma_wgrad_indexed") == "conv backward (weights)"
    assert counts.kind("Memcpy DtoD (Device -> Device)") == \
        "copies and memsets"
    assert counts.kind("void at::native::reduce_kernel") == "reductions"
    assert counts.kind("max_pool3d_with_indices_backward_single_out_frame") \
        == "pooling"
