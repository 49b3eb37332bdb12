"""pack_ms.serve: host ms a video of decode and pack (data/decode.py,
data/pipeline.host_batch), from the benchmark's wrapper around the
engine's pack_paths, over the window."""


def read(record):
    c = record.counters
    if not c.get("packed_videos"):
        return None
    return 1e3 * c["pack_seconds"] / c["packed_videos"]
