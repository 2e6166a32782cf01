"""Batches staged on the device ahead of the train loop (counterpart of
``vince_tpu/data/prefetch.py``).

A daemon thread pulls host batches from the loaders and copies them to the
device into a bounded queue (depth 2), so that the host's collate and the
copy of batch N+1 overlap the device's step N. On a CUDA device each array
goes through a pinned host buffer and a non-blocking copy on a side stream
of the staging thread's own; the copies end in an event. Before the step
reads a staged batch, ``ready`` makes the step's stream wait on that event
and records the tensors on that stream, so that the allocator does not hand
their memory to the next staging before the step has read them.
"""

import dataclasses
import multiprocessing as mp
import queue as queue_lib
import threading
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch


def pull_with_kill(loader, should_stop: Optional[Callable[[], bool]],
                   timeout: float = 0.5):
    """``loader.get_batch`` in bounded waits, polling ``should_stop`` between
    them so that a stop never hangs on a slow loader; None once stopped."""
    while True:
        if should_stop is not None and should_stop():
            return None
        try:
            return loader.get_batch(timeout=timeout)
        except (queue_lib.Empty, mp.TimeoutError):
            continue


@dataclasses.dataclass
class StagedBatch:
    """Per-source dicts of device tensors, and the event that ends their
    copies (None on the CPU, where nothing is copied)."""

    tensors: Tuple[Dict[str, torch.Tensor], ...]
    event: Optional[torch.cuda.Event] = None


def stage(arrays: Sequence[Dict[str, np.ndarray]], device: torch.device,
          stream: Optional[torch.cuda.Stream] = None) -> StagedBatch:
    """Copy per-source dicts of numpy arrays to ``device``: on a CUDA device
    through pinned buffers, without a wait, on ``stream`` (default the current
    one); on the CPU the tensors share the arrays' memory."""
    if device.type != "cuda":
        return StagedBatch(tuple({k: torch.from_numpy(np.ascontiguousarray(v))
                                  for k, v in d.items()} for d in arrays))
    stream = stream or torch.cuda.current_stream(device)
    out = []
    with torch.cuda.stream(stream):
        for d in arrays:
            staged = {}
            for k, v in d.items():
                host = torch.from_numpy(np.ascontiguousarray(v))
                pinned = torch.empty(host.shape, dtype=host.dtype, pin_memory=True)
                staged[k] = pinned.copy_(host).to(device, non_blocking=True)
            out.append(staged)
        event = torch.cuda.Event()
        event.record(stream)
    return StagedBatch(tuple(out), event)


def ready(batch: StagedBatch, device: torch.device) -> Tuple[Dict[str, torch.Tensor], ...]:
    """The staged tensors, ordered before the work that the current stream
    takes next."""
    if batch.event is not None:
        current = torch.cuda.current_stream(device)
        current.wait_event(batch.event)
        for d in batch.tensors:
            for t in d.values():
                t.record_stream(current)
    return batch.tensors


class BatchPrefetcher:
    """Runs ``stage_fn(should_stop)`` on a daemon thread into a bounded queue.

    ``stage_fn`` pulls host batch(es) and stages them on the device; it polls
    ``should_stop()`` between bounded waits (``pull_with_kill``) and returns
    None when stopped, which ends the thread.
    """

    def __init__(self, stage_fn: Callable, depth: int = 2):
        self._stage_fn = stage_fn
        self._queue: queue_lib.Queue = queue_lib.Queue(maxsize=depth)
        self._kill = False
        self._thread: Optional[threading.Thread] = None

    @property
    def running(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def start(self) -> "BatchPrefetcher":
        if self._thread is None:
            self._kill = False
            self._thread = threading.Thread(target=self._loop, daemon=True)
            self._thread.start()
        return self

    def _loop(self):
        bq = self._queue  # a local reference: survives stop() swapping the field
        while not self._kill:
            staged = self._stage_fn(lambda: self._kill)
            if staged is None:
                return
            while not self._kill:
                try:
                    bq.put(staged, timeout=0.5)
                    break
                except queue_lib.Full:
                    continue

    def get(self, timeout: float = 5.0):
        while True:
            try:
                return self._queue.get(timeout=timeout)
            except queue_lib.Empty:
                if not self.running:
                    raise RuntimeError(
                        "batch prefetch thread died; see traceback above"
                    ) from None

    def stop(self):
        self._kill = True
        thread, self._thread = self._thread, None
        if thread is not None:
            thread.join(timeout=10.0)
