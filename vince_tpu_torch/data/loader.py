"""Host input pipeline (counterpart of ``vince_tpu/data/loader.py``): a
persistent loader whose workers (threads, or a pool of processes) outlive
epochs, ``never_ending`` iteration, a bounded queue of ready batches (depth 2),
and failed reads replaced by other items. Workers only decode and resize uint8
canvases; augmentation runs on the device.

The worker processes are spawned, each with its copy of the dataset (read
from a file that this process writes once). Each reseeds the random
generators that its copy holds (``reseed_generators``), so that no two
workers repeat a draw, as JAX's forked workers each reseed numpy's global
generator. Under ``--native-decode`` this process looks the dataset's
``decode_device`` up before it writes the copy; each worker sets that
device and decodes on it, and hands back with each batch the decode's
counters it moved. A worker's exception
is raised by ``get_batch``, and so is a worker's exit, within
``WORKER_POLL_S``.
"""

import multiprocessing as mp
import os
import pickle
import queue
import random
import tempfile
import threading
import time
import types
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np

from vince_tpu_torch import native
from vince_tpu_torch.data.base_dataset import BaseDataset

# how often a wait for a worker process's batch checks that the workers live
WORKER_POLL_S = 1.0
# how long the end of a pool one of whose workers died may take
KILL_WAIT_S = 10.0

# the worker process's dataset, collate function and the loader's stop event
# (set by the initializer)
_WORKER_DATASET = None
_WORKER_COLLATE = None
_WORKER_STOP = None


def dataset_generators(dataset) -> List[Any]:
    """The random generators (numpy ``RandomState``s, ``random.Random``s)
    that ``dataset`` holds as attributes, or its attributes hold (a pair
    dataset's transform shares the dataset's), each once."""
    found: Dict[int, Any] = {}

    def visit(obj, depth):
        for value in vars(obj).values():
            if isinstance(value, (np.random.RandomState, random.Random)):
                found.setdefault(id(value), value)
            elif (depth and hasattr(value, "__dict__")
                  and not isinstance(value, (type, types.ModuleType))):
                visit(value, depth - 1)

    visit(dataset, 1)
    return list(found.values())


def reseed_generators(dataset, worker: int):
    """Reseed each of ``dataset``'s generators in place from its own next
    draw (so from ``--seed``, which seeded it) and the worker's number: the
    workers' streams differ, and a generator that two objects share stays
    shared."""
    for g in dataset_generators(dataset):
        if isinstance(g, np.random.RandomState):
            own = int(g.randint(2 ** 31))
        else:
            own = g.getrandbits(31)
        g.seed(int(np.random.SeedSequence([own, worker]).generate_state(1)[0]))


def _proc_init(dataset_file, collate_fn, seed, numbers, stop):
    global _WORKER_DATASET, _WORKER_COLLATE, _WORKER_STOP
    import torch

    try:
        import cv2

        cv2.setNumThreads(0)  # one decode per process; no nested pools
    except ImportError:
        pass
    torch.set_num_threads(1)  # the plain resize's, likewise
    with numbers.get_lock():
        worker = numbers.value
        numbers.value += 1
    with open(dataset_file, "rb") as f:  # written by this loader's process
        dataset = pickle.load(f)
    device = getattr(dataset, "_decode_device", None)  # fixed by the parent, never looked up
    if device is not None and device.type == "cuda":
        torch.cuda.set_device(device)  # this worker's CUDA context, on the parent's GPU
    _WORKER_DATASET, _WORKER_COLLATE, _WORKER_STOP = dataset, collate_fn, stop
    np.random.seed(int(np.random.SeedSequence([seed, worker]).generate_state(1)[0]))
    reseed_generators(dataset, worker)


def _proc_load(indices):
    """A batch of ``indices`` (None if every read failed, or once the loader
    stops) and the decode's counters that it moved in this worker."""
    before = native.decode_counters()
    items = []
    for i in indices:
        if _WORKER_STOP.is_set():  # shutting down: the batch would not be taken
            return None, native.counters_since(before)
        item = _WORKER_DATASET[i]
        tries = 0
        while item is None and tries < 10:
            item = _WORKER_DATASET[int(np.random.randint(len(_WORKER_DATASET)))]
            tries += 1
        if item is not None:
            items.append(item)
    batch = None
    if items:
        while len(items) < len(indices):
            items.append(items[len(items) % max(len(items), 1)])
        batch = _WORKER_COLLATE(items)
    return batch, native.counters_since(before)


def _end_pool(pool, workers):
    """End a pool one of whose workers died. Its lost job would hold
    ``close`` and ``join`` for good, and ``terminate`` can block on what the
    dead worker held (the task queue's lock, a half-sent batch): it runs on a
    daemon thread for at most ``KILL_WAIT_S``, then every worker left is
    killed."""
    ender = threading.Thread(target=pool.terminate, daemon=True)
    ender.start()
    ender.join(KILL_WAIT_S)
    for p in list(workers) + list(pool._pool):
        if p.is_alive():
            p.kill()


def collate_video_batch(items: Sequence[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
    """Stack per-video dicts and flatten [V, F, ...] → [V*F, ...], the
    frame-major layout of the train step's batch."""
    out: Dict[str, Any] = {}
    keys = items[0].keys()
    for k in keys:
        vals = [it[k] for it in items]
        if isinstance(vals[0], np.ndarray) and vals[0].ndim >= 4:
            # [F, H, W, C] per item → [V*F, H, W, C] frame-major batch
            stacked = np.stack(vals)
            out[k] = stacked.reshape((-1,) + stacked.shape[2:])
        elif isinstance(vals[0], np.ndarray) and vals[0].ndim >= 2:
            # single image / label map per item → plain stack
            out[k] = np.stack(vals)
        elif isinstance(vals[0], (np.integer, int, np.floating, float, np.ndarray)):
            out[k] = np.stack([np.asarray(v) for v in vals]).reshape(-1)
        else:
            out[k] = list(vals)
    return out


class _WorkerError:
    """A loader thread's exception, handed to the consumer in place of a batch."""

    def __init__(self, exc: BaseException):
        self.exc = exc


class PersistentDataLoader:
    """Thread-pool loader over an index-style dataset. An exception in a
    thread (a read that raises, a decode on the card that fails) ends that
    thread and is raised by the consumer's next ``get_batch``."""

    def __init__(
        self,
        dataset=None,
        batch_size: int = 1,  # number of dataset ITEMS per batch (videos)
        num_workers: int = 8,
        shuffle: bool = True,
        never_ending: bool = True,
        collate_fn: Callable = collate_video_batch,
        prefetch: int = 2,
        seed: int = 0,
        use_processes: bool = False,  # a pool of worker processes, not threads
        num_shards: int = 1,  # iterate only indices [shard_id::num_shards]
        shard_id: int = 0,  # of each epoch's permutation (one seed for all shards)
    ):
        if not (0 <= shard_id < max(num_shards, 1)):
            raise ValueError(f"shard_id {shard_id} not in [0, {num_shards})")
        self.num_shards = max(num_shards, 1)
        self.shard_id = shard_id
        self.use_processes = use_processes
        self._pool = None
        self._stopping = None  # the pool's stop event
        self._dataset_file = None  # the dataset, pickled for the pool's workers
        self._workers: List = []
        self._pending: List = []
        self.batch_size = batch_size
        self.num_workers = max(1, num_workers)
        self.shuffle = shuffle
        self.never_ending = never_ending
        self.collate_fn = collate_fn
        self.prefetch = prefetch
        self.seed = seed
        self.dataset = None
        self._queue: Optional[queue.Queue] = None
        self._threads: List[threading.Thread] = []
        self._stop = threading.Event()
        self._epoch_lock = threading.Lock()
        self._order: List[int] = []
        self._cursor = 0
        self._epoch = 0
        if dataset is not None:
            self.set_dataset(dataset)

    # the workers may start before the dataset is known (set_dataset)
    def set_dataset(self, dataset):
        self.shutdown()
        self.dataset = dataset
        self._stop = threading.Event()
        self._rng = np.random.RandomState(self.seed)
        self._reshuffle()
        if self.use_processes:
            # spawn: this process has threads (and may have CUDA), which a
            # forked child would inherit in whatever state they were
            ctx = mp.get_context("spawn")
            self._stopping = ctx.Event()
            # the dataset goes to the workers in a file that each reads: sent
            # with a worker's start, a pickle beyond the pipe's 64 KiB holds
            # this process until the child has imported its modules, and the
            # pool starts its workers one after another (60 s for 8 workers
            # and 2000 ImageNet samples on the card's host)
            if isinstance(dataset, BaseDataset) and native.wanted(dataset.args):
                dataset.decode_device  # looked up here, so that the workers' copies carry it
            fd, self._dataset_file = tempfile.mkstemp(prefix="vince_loader_", suffix=".pkl")
            try:
                with os.fdopen(fd, "wb") as f:
                    pickle.dump(dataset, f, protocol=pickle.HIGHEST_PROTOCOL)
            except BaseException:
                os.unlink(self._dataset_file)
                raise
            self._pool = ctx.Pool(
                self.num_workers,
                initializer=_proc_init,
                initargs=(self._dataset_file, self.collate_fn, self.seed, ctx.Value("i", 0),
                          self._stopping),
            )
            # the processes the pool started: one that exits before shutdown died
            self._workers = list(self._pool._pool)
            self._pending = []
            self._fill_pending()
            return
        self._queue = queue.Queue(maxsize=self.prefetch)
        self._threads = [
            threading.Thread(target=self._worker_loop, daemon=True)
            for _ in range(self.num_workers)
        ]
        for t in self._threads:
            t.start()

    def _fill_pending(self):
        """Keep enough async batch jobs in flight to saturate the pool."""
        target = self.num_workers + self.prefetch
        while len(self._pending) < target:
            indices = self._next_indices()
            if indices is None:
                break
            self._pending.append(self._pool.apply_async(_proc_load, (indices,)))

    def _reshuffle(self):
        n = len(self.dataset)
        # epoch permutations are a pure function of (seed, epoch), not a
        # shared RNG stream, so that every shard sees the same permutation
        # however its reads consume randomness
        rng = np.random.RandomState((self.seed * 1_000_003 + self._epoch) % (2**31))
        order = list(rng.permutation(n) if self.shuffle else range(n))
        if self.num_shards > 1:
            if self.never_ending and n % self.num_shards:
                # equal shard sizes (the permutation wraps): unequal shards
                # would reshuffle at different times and overlap
                order = order + order[: self.num_shards - (n % self.num_shards)]
            # disjoint stride slices tile the (padded) epoch
            order = order[self.shard_id :: self.num_shards]
        self._order = order
        self._cursor = 0

    def _next_indices(self) -> Optional[List[int]]:
        with self._epoch_lock:
            if not self._order:
                raise RuntimeError(
                    f"loader shard {self.shard_id}/{self.num_shards} has no "
                    f"items (dataset len {len(self.dataset)}) — fewer items "
                    "than shards/processes?"
                )
            idx: List[int] = []
            while len(idx) < self.batch_size:
                if self._cursor >= len(self._order):
                    if not self.never_ending and not idx:
                        return None
                    if not self.never_ending:
                        break
                    self._epoch += 1
                    self._reshuffle()
                take = min(self.batch_size - len(idx), len(self._order) - self._cursor)
                idx.extend(self._order[self._cursor : self._cursor + take])
                self._cursor += take
            return idx

    def _put(self, value):
        """A bounded put, so that the thread ends even if the consumer
        stopped reading."""
        while not self._stop.is_set():
            try:
                self._queue.put(value, timeout=0.5)
                return
            except queue.Full:
                continue

    def _worker_loop(self):
        try:
            import cv2

            cv2.setNumThreads(0)  # avoid nested-pool oversubscription
        except ImportError:
            pass
        try:
            self._load_batches()
        except BaseException as exc:  # handed on, not lost with the thread
            self._put(_WorkerError(exc))

    def _load_batches(self):
        while not self._stop.is_set():
            indices = self._next_indices()
            if indices is None:
                self._put(None)  # end of data
                return
            items = []
            for i in indices:
                item = self.dataset[i]
                tries = 0
                while item is None and tries < 10:  # resample failed reads
                    item = self.dataset[int(self._rng.randint(len(self.dataset)))]
                    tries += 1
                if item is not None:
                    items.append(item)
            if not items:
                continue
            while len(items) < len(indices):  # keep shapes static
                items.append(items[len(items) % max(len(items), 1)])
            self._put(self.collate_fn(items))

    def _dead_workers(self) -> List:
        return [p for p in self._workers if p.exitcode is not None]

    def _result(self, job, timeout: Optional[float]):
        """``job``'s result, waited for in steps of ``WORKER_POLL_S`` that
        check the workers: ``mp.TimeoutError`` after ``timeout``, a
        RuntimeError for a worker's exception or a worker that exited."""
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            left = WORKER_POLL_S if deadline is None else deadline - time.monotonic()
            try:
                return job.get(timeout=max(min(left, WORKER_POLL_S), 0.0))
            except mp.TimeoutError:
                dead = self._dead_workers()
                if dead:
                    raise RuntimeError(
                        f"a loader worker process exited (pid {dead[0].pid}, exit code "
                        f"{dead[0].exitcode}) before its batch was done") from None
                if deadline is not None and time.monotonic() >= deadline:
                    raise
            except Exception as exc:  # raised in the worker, handed on
                raise RuntimeError("a loader worker process failed") from exc

    def get_batch(self, timeout: Optional[float] = None):
        if self.use_processes:
            while True:
                if not self._pending:
                    # end of data (never_ending=False), as the threads' None
                    return None
                # peek, then pop: a get that times out keeps its job
                batch, moved = self._result(self._pending[0], timeout)
                self._pending.pop(0)
                native.add_counters(moved)
                self._fill_pending()
                if batch is None:
                    continue
                return batch
        batch = self._queue.get(timeout=timeout)
        if isinstance(batch, _WorkerError):
            raise RuntimeError("a loader thread failed") from batch.exc
        return batch

    def __iter__(self):
        finished = 0
        while True:
            batch = self.get_batch()
            if batch is None:
                if self.use_processes:
                    return  # one end-of-data signal, not one per worker
                finished += 1
                if finished >= self.num_workers:
                    return
                continue
            yield batch

    def shutdown(self):
        if self._pool is not None:
            pool, self._pool = self._pool, None
            if self._dead_workers():
                _end_pool(pool, self._workers)
            else:
                # stop, close, then join: the jobs in flight end at their next
                # item and their workers exit. terminate() can hang for good:
                # the pool's result thread may be reading a batch that a killed
                # worker had half sent. The counters of the batches not taken
                # are kept.
                self._stopping.set()
                pool.close()
                pool.join()
                for job in self._pending:
                    if job.ready() and job.successful():
                        native.add_counters(job.get()[1])
            os.unlink(self._dataset_file)
            self._pending, self._workers = [], []
        if self._threads:
            self._stop.set()
            for t in self._threads:
                t.join(timeout=2.0)
            self._threads = []
        self._queue = None
