"""k2_roofline.dp: the reading of benchmark/metrics/k2_roofline.train.py in the
data-parallel cells, where it moves train_clips_per_s.dp."""

from benchmark import harness


def read(record):
    return harness.load_reader(record.root, "k2_roofline.train")(record)
