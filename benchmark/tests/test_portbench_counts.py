"""The frozen FLOP count against torch.utils.flop_counter on the port's
models at small clip shapes, and the frozen bound arithmetic against the
numbers it was copied with."""

import math

import pytest
import torch
import torch.nn.functional as F
from torch.utils.flop_counter import FlopCounterMode

from benchmark.reference.models import Net
from benchmark.yardstick import arch, counts, weights

# a network of one channel-wise conv (groups = channels), found by name as
# any network is: 3x3x3 as in X3D's blocks, (5,1,1) as in its stem
CHANNELWISE = '''
from benchmark.yardstick import arch


def describe(clip_len, size):
    w = arch._Walk((clip_len, size, size))
    w.conv("dw", {c}, {c}, {kernel}, 1, {padding}, groups={c})
    return w.convs, w.epilogues, []
'''
KERNELS = [((3, 3, 3), (1, 1, 1)), ((5, 1, 1), (2, 0, 0))]


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
    ("r3d_18", 4, 32, 2),
    ("r3d_18", 8, 64, 1),
    ("mc3_18", 4, 32, 2),
    ("mc3_18", 8, 64, 1),
])
def test_forward_flops_match_flop_counter(network, clip_len, size, clips):
    model = _port_model(network, clip_len, size)
    x = torch.zeros(clips, 1, clip_len, size, size, 3)
    with torch.no_grad(), FlopCounterMode(display=False) as fc:
        model(x)
    convs, _, linears = arch.network(network, clip_len, size)
    assert counts.forward_flops(convs, linears, clips) == fc.get_total_flops()


def _channelwise(tmp_path, kernel, padding, channels):
    """Net of the one channel-wise conv at 8x14x14 (a file of its own)."""
    (tmp_path / "benchmark" / "networks").mkdir(parents=True, exist_ok=True)
    (tmp_path / "benchmark" / "networks" / f"dw{channels}.py").write_text(
        CHANNELWISE.format(c=channels, kernel=kernel, padding=padding))
    return Net(f"dw{channels}", 8, 14, str(tmp_path))


@pytest.mark.parametrize("kernel,padding", KERNELS)
def test_channelwise_conv_flops_match_flop_counter(tmp_path, kernel,
                                                   padding):
    net = _channelwise(tmp_path, kernel, padding, 192)
    x, w = torch.zeros(2, 192, 8, 14, 14), torch.zeros(192, 1, *kernel)
    with FlopCounterMode(display=False) as fc:
        F.conv3d(x, w, None, 1, padding, 1, 192)
    assert counts.conv_flops(net.convs[0], 2) == fc.get_total_flops()


@pytest.mark.parametrize("kernel,padding", KERNELS)
def test_channelwise_conv_weights(tmp_path, kernel, padding):
    w = weights.make(_channelwise(tmp_path, kernel, padding, 4096), 5,
                     "cpu")["dw.weight"]
    assert w.shape == (4096, 1, *kernel)
    # He over a fan-in of prod(kernel): the sample's std and mean within
    # 5 standard errors of n draws
    n, want = w.numel(), math.sqrt(2.0 / math.prod(kernel))
    assert abs(float(w.std()) / want - 1) < 5 / math.sqrt(2 * n)
    assert abs(float(w.mean())) < 5 * want / math.sqrt(n)


@pytest.mark.parametrize("kernel,padding", KERNELS)
def test_channelwise_reference_conv(tmp_path, kernel, padding):
    net = _channelwise(tmp_path, kernel, padding, 192)
    params = weights.make(net, 5, "cpu")
    x = torch.randn((2, 192, 8, 14, 14),
                    generator=torch.Generator().manual_seed(1))
    got = net.conv(params, "dw", x, lambda t: t)
    want = F.conv3d(x, params["dw.weight"], None, 1, padding, 1, 192)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


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
