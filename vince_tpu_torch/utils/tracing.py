"""The port's spans, counters and timed device regions. Off unless ``enable()``
turns it on (the solver does with ``--profile-dir``); off, a call site costs
one flag check and gets a shared no-op, nothing is kept, and a CUDA graph is
captured with nothing added to it.

- ``span(name)``: a ``torch.profiler.record_function`` range, on the
  profiler's clock beside the kernels it launches, and its host seconds kept
  by name (set-up runs where no profiler does).
- ``count(name, value)``: a value kept by name.
- ``regions(names, device)``: timed device regions, one timing event a
  boundary (``Regions``). Events recorded while a CUDA graph is captured are
  its event-record nodes (``external``), and time every replay. A set whose
  last boundary passed waits until ``read_regions`` is called, once the
  step's work is done, and then gives one entry of milliseconds by region.
- ``records()`` and ``reset()``: what was kept, and its clearing. The caller
  writes it out; this module writes no file.

Names: ``vince.setup.*`` (``init_vince_state``), ``vince.kernels.load``
(``ops/kernels/build.py``), ``vince.step.*`` (the train steps of
``solvers/vince_step.py``), ``vince.iter.*`` (``VinceSolver``'s iteration).
"""

import contextlib
import time
from collections import defaultdict
from typing import Dict, List, Sequence

import torch

_on = False
_spans: Dict[str, List[float]] = defaultdict(list)
_counters: Dict[str, list] = defaultdict(list)
_regions: List[Dict[str, float]] = []
_pending: List["Regions"] = []
_OFF = contextlib.nullcontext()


def enable() -> None:
    global _on
    _on = True


def disable() -> None:
    global _on
    _on = False


def enabled() -> bool:
    return _on


class _Span:
    """A profiler range whose host seconds are kept under its name."""

    __slots__ = ("name", "_range", "_t0")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self._range = torch.profiler.record_function(self.name)
        self._range.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        _spans[self.name].append(time.perf_counter() - self._t0)
        self._range.__exit__(*exc)
        return False


def span(name: str):
    """A ``vince.*`` range around the block, when tracing is on."""
    return _Span(name) if _on else _OFF


def count(name: str, value) -> None:
    """Keep ``value`` under ``name``, when tracing is on."""
    if _on:
        _counters[name].append(value)


class Regions:
    """Consecutive device regions of one step: ``mark()`` records the next
    boundary on the current stream, len(names) + 1 marks a step. The events
    live as long as this object, so a graph that captured them keeps it."""

    def __init__(self, names: Sequence[str]):
        self.names = tuple(names)
        self.events = [torch.cuda.Event(enable_timing=True, external=True)
                       for _ in range(len(self.names) + 1)]
        self._next = 0

    def mark(self) -> None:
        self.events[self._next].record()
        self._next += 1
        if self._next == len(self.events):
            self._next = 0
            self.arm()

    def arm(self) -> None:
        """Wait to be read: after the last mark, and after each replay of a
        graph that captured the marks."""
        if _on and self not in _pending:
            _pending.append(self)


class _NoRegions:
    def mark(self) -> None:
        pass

    def arm(self) -> None:
        pass


NO_REGIONS = _NoRegions()


def regions(names: Sequence[str], device):
    """A set of timed regions on a CUDA ``device`` when tracing is on, else
    the shared no-op."""
    if _on and torch.device(device).type == "cuda":
        return Regions(names)
    return NO_REGIONS


def read_regions() -> None:
    """Keep the milliseconds of each set waiting to be read, one entry a set;
    called once the sets' work is done (``metrics_to_host``'s copy)."""
    while _pending:
        ev, names = _pending[0].events, _pending.pop(0).names
        ev[-1].synchronize()
        _regions.append({n: ev[i].elapsed_time(ev[i + 1]) for i, n in enumerate(names)})


def records() -> dict:
    """What was kept: ``spans`` (host seconds of each range, by name),
    ``counters`` (values by name) and ``regions`` (milliseconds by region,
    one entry a step read)."""
    return {"spans": {k: list(v) for k, v in _spans.items()},
            "counters": {k: list(v) for k, v in _counters.items()},
            "regions": [dict(r) for r in _regions]}


def reset() -> None:
    """Drop what was kept and the sets waiting to be read."""
    _spans.clear()
    _counters.clear()
    _regions.clear()
    _pending.clear()
