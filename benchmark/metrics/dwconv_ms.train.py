"""dwconv_ms.train: device ms a step of the channel-wise convs forward and
backward (X3D's 27 a forward), from the CUDA-event brackets of the
program's `conv.depthwise` spans and their `conv.depthwise.backward`
brackets inside the traced window, over its steps. Nothing where the
program keeps no such span."""

from benchmark.yardstick import spans


def read(record):
    return spans.device_ms_per_step(record, ("conv.depthwise",
                                             "conv.depthwise.backward"))
