"""k2_roofline.train: K2's share of its roofline in the train step.

The bound time of every K2 launch of a step (each epilogue forward and
backward, every operand's bytes once at 3.35 TB/s against its float32
operations, by the frozen epilogue_bytes_flops) x the traced window's steps
/ the device time of K2's kernels in the trace (process 0's card), in %.
Nothing where the trace holds no K2 kernel (C3D has no BN).
"""

from benchmark.yardstick import arch, counts


def read(record):
    trace = record.trace
    if trace is None or not record.steps:
        return None
    spent = trace.device_seconds(
        lambda n: "bn_apply_relu" in n or "bn_bwd" in n)
    if spent <= 0:
        return None
    cfg = record.cfg
    _, epilogues, _ = arch.network(cfg["network"], cfg["clip_len"],
                                   cfg["size"], record.root)
    bound = counts.k2_step_bound_seconds(epilogues, record.local_clips)
    return 100.0 * bound * record.steps / spent
