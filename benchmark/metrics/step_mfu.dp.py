"""step_mfu.dp: the reading of benchmark/metrics/step_mfu.train.py in the
data-parallel cells, where it moves train_clips_per_s.dp."""

from benchmark import harness


def read(record):
    return harness.load_reader(record.root, "step_mfu.train")(record)
