"""dispatch_ms.serve: host ms of one engine dispatch (H2D, K1, the forward
and the copy back), device_seconds / dispatches of engine.stats() over the
window."""


def read(record):
    c = record.counters
    if not c.get("dispatches"):
        return None
    return 1e3 * c["device_seconds"] / c["dispatches"]
