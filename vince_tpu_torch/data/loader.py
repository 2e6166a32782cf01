"""Host input pipeline (counterpart of ``vince_tpu/data/loader.py``): a
persistent loader whose workers (threads, or a pool of processes) outlive
epochs, ``never_ending`` iteration, a bounded queue of ready batches (depth 2),
and failed reads replaced by other items. Workers only decode and resize uint8
canvases; augmentation runs on the device.
"""

import multiprocessing as mp
import queue
import threading
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np

# the worker process's dataset and collate function (set by the initializer)
_WORKER_DATASET = None
_WORKER_COLLATE = None


def _proc_init(dataset, collate_fn, seed):
    global _WORKER_DATASET, _WORKER_COLLATE
    try:
        import cv2

        cv2.setNumThreads(0)  # one decode per process; no nested pools
    except ImportError:
        pass
    _WORKER_DATASET = dataset
    _WORKER_COLLATE = collate_fn
    np.random.seed(seed + mp.current_process().pid % 100000)


def _proc_load(indices):
    items = []
    for i in indices:
        item = _WORKER_DATASET[i]
        tries = 0
        while item is None and tries < 10:
            item = _WORKER_DATASET[int(np.random.randint(len(_WORKER_DATASET)))]
            tries += 1
        if item is not None:
            items.append(item)
    if not items:
        return None
    while len(items) < len(indices):
        items.append(items[len(items) % max(len(items), 1)])
    return _WORKER_COLLATE(items)


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
            self._pool = ctx.Pool(
                self.num_workers,
                initializer=_proc_init,
                initargs=(dataset, self.collate_fn, self.seed),
            )
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

    def get_batch(self, timeout: Optional[float] = None):
        if self.use_processes:
            while True:
                if not self._pending:
                    # end of data (never_ending=False), as the threads' None
                    return None
                # peek, then pop: a get that times out keeps its job
                job = self._pending[0]
                batch = job.get(timeout=timeout)
                self._pending.pop(0)
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
            # close, then join: the jobs in flight end and their workers exit.
            # terminate() can hang for good: the pool's result thread may be
            # reading a batch that a killed worker had half sent
            self._pool.close()
            self._pool.join()
            self._pool = None
            self._pending = []
        if self._threads:
            self._stop.set()
            for t in self._threads:
                t.join(timeout=2.0)
            self._threads = []
        self._queue = None
