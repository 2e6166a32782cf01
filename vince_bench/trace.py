"""A torch.profiler trace of a stretch of whole steps, reduced to what the
per-layer readers take: every device kernel (name, start, end), the
benchmark's host spans (``bench.*`` labels around its calls into the
program), the stretch's wall interval and its step count.

Times are in seconds on the profiler's clock. Device busy time is the union
of the kernels' intervals inside the stretch; the rest of the stretch is
idle, and each idle gap is put down to the host spans it overlaps (the
benchmark's spans do not nest).
"""

import contextlib
import dataclasses
import re
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import torch

STRETCH = "bench.stretch"
OTHER_HOST = "host outside the benchmark's spans"


@dataclasses.dataclass
class Trace:
    kernels: List[Tuple[str, float, float]]
    spans: List[Tuple[str, float, float]]
    start: float
    end: float
    steps: int

    @property
    def window_s(self) -> float:
        return self.end - self.start

    def busy_s(self) -> float:
        busy, reach = 0.0, self.start
        for _, s, e in sorted(self.kernels, key=lambda k: k[1]):
            s, e = max(s, reach), min(e, self.end)
            if e > s:
                busy += e - s
                reach = e
        return busy

    def kernel_seconds(self) -> Dict[str, float]:
        out: Dict[str, float] = defaultdict(float)
        for name, s, e in self.kernels:
            out[name] += e - s
        return dict(out)

    def matching(self, pattern: str) -> List[Tuple[str, float, float]]:
        rx = re.compile(pattern)
        return [k for k in self.kernels if rx.search(k[0])]

    def idle_gaps(self) -> Dict[str, float]:
        """Idle seconds by what the host was doing: each gap's time inside
        each of the benchmark's host spans, the rest under ``OTHER_HOST``."""
        gaps, reach = [], self.start
        for _, s, e in sorted(self.kernels, key=lambda k: k[1]) + [("", self.end, self.end)]:
            s = min(s, self.end)
            if s > reach:
                gaps.append((reach, s))
            reach = max(reach, e)
        spans = [(s, e, name) for name, s, e in self.spans if name != STRETCH]
        out: Dict[str, float] = defaultdict(float)
        for a, b in gaps:
            covered = 0.0
            for s, e, name in spans:
                overlap = min(b, e) - max(a, s)
                if overlap > 0:
                    out[name] += overlap
                    covered += overlap
            if b - a - covered > 0:
                out[OTHER_HOST] += b - a - covered
        return dict(out)


def short(name: str, width: int = 120) -> str:
    """A kernel's name without its template arguments and parameters."""
    name = name.replace("(anonymous namespace)::", "")
    while True:
        cut = re.sub(r"<[^<>]*>", "", name)
        if cut == name:
            break
        name = cut
    name = re.sub(r"\([^()]*\)$", "", name).removeprefix("void ").strip()
    return name[:width] or "(unnamed)"


def top(seconds: Dict[str, float], n: int = 10) -> List[list]:
    return [[k, v] for k, v in sorted(seconds.items(), key=lambda kv: -kv[1])[:n]]


def _activities():
    from torch.profiler import ProfilerActivity

    return [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])


class Tracer:
    """Starts the profiler at a step boundary and reduces its events."""

    def __init__(self):
        self.prof = None
        self.steps = 0

    @staticmethod
    def warm() -> None:
        """One short session, so that starting the stretch's is cheap."""
        from torch.profiler import profile

        with profile(activities=_activities()):
            torch.zeros(1, device="cuda").add_(1)
            torch.cuda.synchronize()

    def start(self) -> None:
        from torch.profiler import profile

        self.prof = profile(activities=_activities())
        self.prof.start()
        self._stretch = torch.profiler.record_function(STRETCH)
        self._stretch.__enter__()

    @property
    def on(self) -> bool:
        return self.prof is not None

    def span(self, name: str):
        return torch.profiler.record_function(name) if self.on else contextlib.nullcontext()

    def stop(self) -> Optional[Trace]:
        if not self.on:
            return None
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self._stretch.__exit__(None, None, None)
        self.prof.stop()
        kernels, spans = [], []
        for e in self.prof.events():
            start, end = e.time_range.start / 1e6, e.time_range.end / 1e6
            if e.device_type == torch.autograd.DeviceType.CUDA:
                if not getattr(e, "is_user_annotation", False):
                    kernels.append((e.name, start, end))
            elif e.name.startswith("bench."):
                spans.append((e.name, start, end))
        stretch = [(s, e) for name, s, e in spans if name == STRETCH]
        if not stretch:
            raise RuntimeError("the trace holds no stretch span")
        return Trace(kernels, spans, stretch[0][0], stretch[0][1], self.steps)
