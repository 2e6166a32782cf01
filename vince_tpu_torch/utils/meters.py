"""Average meters and the phase stopwatch (counterpart of
``vince_tpu/utils/meters.py``)."""

import collections
import time
from typing import Deque, Optional


class AverageMeter:
    """Running mean over all updates since ``reset``."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.sum = 0.0
        self.count = 0

    def update(self, value: float, n: int = 1):
        self.sum += float(value) * n
        self.count += n

    @property
    def value(self) -> float:
        return self.sum / max(self.count, 1)


class RollingAverageMeter:
    """Mean over the last ``window`` updates."""

    def __init__(self, window: int = 100):
        self.window = window
        self.values: Deque[float] = collections.deque(maxlen=window)

    def reset(self):
        self.values.clear()

    def update(self, value: float):
        self.values.append(float(value))

    @property
    def value(self) -> float:
        return sum(self.values) / max(len(self.values), 1)


class Stopwatch:
    """Laps of an iteration's phases on the host clock."""

    def __init__(self):
        self._t: Optional[float] = None
        self._t0: Optional[float] = None

    def start(self):
        self._t = time.perf_counter()
        self._t0 = self._t
        return self

    def lap(self) -> float:
        now = time.perf_counter()
        dt = now - (self._t if self._t is not None else now)
        self._t = now
        return dt

    def total(self) -> float:
        """Wall time since ``start``: the laps and any remainder."""
        now = time.perf_counter()
        return now - (self._t0 if self._t0 is not None else now)
