"""k1_roofline: K1 (queue_logsumexp: ``qlse_partial_kernel`` and
``qlse_combine_kernel``) at the cell's shapes, its least time by
``vince_bench/counts.py`` over its device time a call in the traced stretch."""

from vince_bench import counts

LAYER = "kernels"
MOVES = "frames_per_s"


def read(rec):
    t = rec.trace
    if t is None:
        return None
    calls = len(t.matching(r"qlse_partial_kernel"))
    seconds = sum(e - s for _, s, e in t.matching(r"qlse_\w+_kernel"))
    if calls == 0 or seconds <= 0:
        return None
    c = rec.config
    bound = counts.k1_bound_s(c["batch_size"], c["vince_queue_size"], c["vince_embedding_size"])
    return 100.0 * bound * calls / seconds
