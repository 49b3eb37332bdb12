"""se_swish_ms.train: device ms a step of X3D's conv_b epilogues after
their BN (squeeze-and-excitation where a block has one, then Swish; 26 a
forward), forward and backward, from the CUDA-event brackets of the
program's `se_swish` spans and their `se_swish.backward` brackets inside
the traced window, over its steps. Nothing where the program keeps no such
span."""

from benchmark.yardstick import spans


def read(record):
    return spans.device_ms_per_step(record, ("se_swish", "se_swish.backward"))
