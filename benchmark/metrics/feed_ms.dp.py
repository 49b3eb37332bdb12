"""feed_ms.dp: the reading of benchmark/metrics/feed_ms.train.py in the
data-parallel cells, where it moves train_clips_per_s.dp."""

from benchmark import harness


def read(record):
    return harness.load_reader(record.root, "feed_ms.train")(record)
