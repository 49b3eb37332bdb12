"""bn_stats_ms.train: device ms a step of the BN statistics forward and
backward (models/layers.bn_statistics), from the CUDA-event brackets of the
program's `bn.stats` and `bn.stats.backward` spans inside the traced
window, over its steps. Nothing where the program keeps no such span."""

from benchmark.yardstick import spans


def read(record):
    return spans.device_ms_per_step(record, ("bn.stats",
                                             "bn.stats.backward"))
