"""feed_ms.train: host ms a step inside data.pipeline.device_batch
(pinning, the H2D copies and K1's launch), from the benchmark's own span
around the call, over the traced window's steps."""


def read(record):
    spans = record.seconds.get("feed")
    if not spans:
        return None
    return 1e3 * sum(spans) / len(spans)
