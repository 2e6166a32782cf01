"""step_host_ms: the median over the window's untraced steps of the host's
milliseconds from the step's call to its return, before any synchronise:
the draws, the copies into the captured graph's inputs and the replay's
launch (``vince_step.py::_draw_step`` and ``_CapturedTrainStep``)."""

import statistics

LAYER = "draws and replay call"
MOVES = "frames_per_s"


def read(rec):
    return statistics.median(rec.host_ms) if rec.host_ms else None
