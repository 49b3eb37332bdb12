"""nccl_ms.dp: device ms of NCCL's kernels a step on process 0's card, from
the trace of the window."""


def read(record):
    trace = record.trace
    if trace is None or not record.steps:
        return None
    spent = trace.device_seconds(lambda n: "nccl" in n.lower())
    if spent <= 0:
        return None
    return 1e3 * spent / record.steps
