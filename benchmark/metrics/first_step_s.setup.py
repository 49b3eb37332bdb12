"""first_step_s.setup: host seconds of the process's first train step
(cuDNN's autotuning and the step's first launches), from the always-on
totals of the program's `train.step` span: set-up runs before the
profiler starts. Nothing where the program keeps no such span."""

from benchmark.yardstick import spans


def read(record):
    return spans.first_seconds("train.step")
