"""dwconv_roofline.train: the channel-wise convs' share of their roofline
in the train step.

The bound of a step's channel-wise convs forward and backward (every
operand's bytes once in bf16 at 3.35 TB/s, benchmark/yardstick/
channelwise.py, from the configuration's description) / the device ms a
step of the program's `conv.depthwise` spans and backward brackets inside
the traced window, in %. Nothing where the program keeps no such span or
the network has no channel-wise conv.
"""

from benchmark.yardstick import arch, channelwise, spans


def read(record):
    ms = spans.device_ms_per_step(record, ("conv.depthwise",
                                           "conv.depthwise.backward"))
    if not ms:
        return None
    cfg = record.cfg
    convs, _, _ = arch.network(cfg["network"], cfg["clip_len"], cfg["size"],
                               record.root)
    bound = channelwise.step_bound_seconds(convs, record.local_clips)
    if bound <= 0:
        return None
    return 100.0 * 1e3 * bound / ms
