"""optimizer_ms.train: device ms a step of the guarded Adam (the guard's
norms included), from the CUDA events of the program's `train.optimizer`
span inside the traced window, over its steps. Nothing where the program
keeps no such span."""

from benchmark.yardstick import spans


def read(record):
    return spans.device_ms_per_step(record, ("train.optimizer",))
