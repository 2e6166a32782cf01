"""data_wait_ms: the mean over the window's iterations of the solver's wait
for its staged batch (``data_cache_time``: the loader and the staging
thread, ``data/loader.py`` and ``data/prefetch.py``), in milliseconds. Only
the ``files`` traffic, which runs the training command, records it."""

LAYER = "loader and staging"
MOVES = "frames_per_s"


def read(rec):
    waits = rec.counters.get("data_wait_ms")
    return sum(waits) / len(waits) if waits else None
