"""device_idle_pct: the share of the traced stretch's wall time (whole steps
at the end of the window) in which no kernel ran on the card."""

LAYER = "device"
MOVES = "frames_per_s"


def read(rec):
    t = rec.trace
    if t is None or not t.kernels or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s() / t.window_s)
