"""step_mfu.train: the whole train step's share of the cards' bf16 peak.

The frozen FLOP count of forward plus backward (three times the forward,
from the configuration's shapes; recomputation not counted) x the steps of
the traced window / its seconds / (cards x 989 TFLOP/s), in %.
"""

from benchmark.yardstick import arch, counts


def read(record):
    if record.trace is None or not record.steps:
        return None
    cfg = record.cfg
    convs, _, linears = arch.network(cfg["network"], cfg["clip_len"],
                                     cfg["size"], record.root)
    flops = counts.train_flops(convs, linears, record.clips_per_step)
    rate = flops * record.steps / record.trace.window_s
    return 100.0 * rate / (record.chips * counts.BF16_FLOPS_PER_S)
