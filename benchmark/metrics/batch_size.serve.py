"""batch_size.serve: videos a micro-batch over the window, from the
MicroBatcher's own counters (its requests and batches over the window,
the mean_batch of serve/batcher.stats())."""


def read(record):
    c = record.counters
    if not c.get("batches"):
        return None
    return c["batched_requests"] / c["batches"]
