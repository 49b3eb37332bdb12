"""idle_share.dp: the reading of benchmark/metrics/idle_share.train.py in the
data-parallel cells, where it moves train_clips_per_s.dp."""

from benchmark import harness


def read(record):
    return harness.load_reader(record.root, "idle_share.train")(record)
