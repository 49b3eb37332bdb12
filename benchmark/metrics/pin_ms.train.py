"""pin_ms.train: host ms a step that data/pipeline._to_device spends
pinning fresh copies of the host batch's arrays, from the program's
`feed.pin` spans inside the traced window, over its steps. Nothing where
the program keeps no such span."""

from benchmark.yardstick import spans


def read(record):
    return spans.host_ms_per_step(record, ("feed.pin",))
