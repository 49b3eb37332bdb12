"""idle_share.serve: the share of the traced window in which no operation
ran on the device, in %."""


def read(record):
    trace = record.trace
    if trace is None or trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s() / trace.window_s)
