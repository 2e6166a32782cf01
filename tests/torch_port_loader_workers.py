"""Datasets for the port's loader in worker processes, in a module without JAX
that a spawned worker imports when it unpickles them
(``tests/test_torch_port_native_decode_processes.py``).

- ``PeekR2V2``, ``PeekKinetics``, ``PeekGOT10k``: the port's datasets, each
  item with the next draw of the generator that the dataset holds (peeked,
  not taken) and the worker's pid; ``PeekAll`` serves the three from one
  pool, every worker waiting for the others before its first item, so that
  both workers of the pool read.
- ``DeviceProbe``: an R2V2 dataset that, in the worker that unpickles it,
  records the device that the worker sets and the device that each decode
  is asked for (and decodes on the CPU), and refuses to look a device up.
- ``RaisingDataset``, ``ExitingDataset``: a read that raises, a worker that
  exits.
"""

import json
import os
import time

import cv2
import numpy as np
import torch

from vince_tpu_torch import native
from vince_tpu_torch.data.got10k_dataset import GOT10kDataset
from vince_tpu_torch.data.kinetics_dataset import Kinetics400Dataset
from vince_tpu_torch.data.r2v2_dataset import R2V2Dataset
from vince_tpu_torch.parallel import multihost


def write_jpg(path, seed, shape=(60, 80)):
    """A smooth frame of ``shape`` from the seed, written by cv2."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    img = cv2.resize(np.random.RandomState(seed).randint(0, 256, (6, 8, 3), np.uint8),
                     shape[::-1], interpolation=cv2.INTER_CUBIC)
    assert cv2.imwrite(path, img)


def write_r2v2_tree(root, videos=6, frames=4, splits=("train", "val")):
    """R2V2's layout (``<split>/AA/<vid>_%06d.jpg``), which Kinetics' frame
    cache shares; returns the train split's video ids."""
    vids = {}
    for s, split in enumerate(splits):
        vids[split] = [f"{'AB'[v % 2]}vid{s}{v:07d}" for v in range(videos)]
        for v, vid in enumerate(vids[split]):
            for f in range(frames):
                write_jpg(os.path.join(root, split, vid[:2], f"{vid}_{f:06d}.jpg"),
                          1000 * s + 10 * v + f)
    return vids[splits[0]]


def write_kinetics_tree(root, videos=6, frames=6):
    vids = write_r2v2_tree(root, videos, frames, splits=("train",))
    os.makedirs(os.path.join(root, "annotations"), exist_ok=True)
    with open(os.path.join(root, "annotations", "train.json"), "w") as f:
        json.dump({vid: {"annotations": {"label": f"class_{v % 3}"}}
                   for v, vid in enumerate(vids)}, f)


def write_got10k_tree(root, seqs=3, frames=6, size=160):
    """GOT-10k's train layout (``train/list.txt``, ``train/<seq>/%08d.jpg``,
    ``groundtruth.txt``) of drifting squares with exact boxes."""
    from vince_tpu_torch.tracking.sequences import SyntheticSequences

    synthetic = SyntheticSequences(num_seqs=seqs, num_frames=frames, size=size)
    base = os.path.join(root, "train")
    for i, name in enumerate(synthetic.seq_names):
        images, boxes = synthetic[i]
        os.makedirs(os.path.join(base, name))
        for f, image in enumerate(images):
            assert cv2.imwrite(os.path.join(base, name, f"{f + 1:08d}.jpg"), image[:, :, ::-1])
        np.savetxt(os.path.join(base, name, "groundtruth.txt"), boxes, fmt="%.2f",
                   delimiter=",")
    with open(os.path.join(base, "list.txt"), "w") as f:
        f.write("\n".join(synthetic.seq_names) + "\n")


class _PeekDraw:
    """Each item with ``draw``, the next value of ``self.rng`` (its state put
    back), and ``pid``."""

    SLEEP_S = 0.02  # per item, so that the reads spread over the workers

    def __getitem__(self, idx):
        state = self.rng.get_state()
        draw = self.rng.randint(2 ** 31)
        self.rng.set_state(state)
        item = super().__getitem__(idx)
        time.sleep(self.SLEEP_S)
        if item is None:
            return None
        return dict(item, draw=np.int64(draw), pid=np.int64(os.getpid()))


class PeekR2V2(_PeekDraw, R2V2Dataset):
    pass


class PeekKinetics(_PeekDraw, Kinetics400Dataset):
    pass


class PeekGOT10k(_PeekDraw, GOT10kDataset):
    pass


class PeekAll:
    """The three peeking datasets as one, for one pool: each an attribute
    (where the loader finds their generators), their items one after
    another, each with ``part``, its dataset's attribute name. Before its
    first item a worker leaves a file named by its pid in ``barrier_dir``
    and waits until ``workers`` such files are there."""

    PARTS = ("r2v2", "kinetics", "got10k")

    def __init__(self, r2v2, kinetics, got10k, barrier_dir, workers=2):
        self.r2v2, self.kinetics, self.got10k = r2v2, kinetics, got10k
        self.barrier_dir, self.workers = barrier_dir, workers

    def __len__(self):
        return sum(len(getattr(self, part)) for part in self.PARTS)

    def _wait_for_the_other_workers(self):
        open(os.path.join(self.barrier_dir, str(os.getpid())), "w").close()
        deadline = time.monotonic() + 120
        while len(os.listdir(self.barrier_dir)) < self.workers:
            if time.monotonic() > deadline:
                raise TimeoutError("the other workers did not start")
            time.sleep(0.01)

    def __getitem__(self, idx):
        if not getattr(self, "_waited", False):
            self._wait_for_the_other_workers()
            self._waited = True
        for part in self.PARTS:
            dataset = getattr(self, part)
            if idx < len(dataset):
                item = dataset[idx]
                return None if item is None else dict(item, part=part)
            idx -= len(dataset)
        raise IndexError(idx)


# what a worker that unpickled a DeviceProbe saw
_SEEN = {"set_device": None, "decode": []}


def _looked_up(*args, **kwargs):
    raise AssertionError("a worker process looked its device up")


def _set_device(device):
    _SEEN["set_device"] = str(device)


def _decode_files(paths, canvas, device):
    _SEEN["decode"].append(str(device))
    return native.decode_jpegs([native._read(p) for p in paths], canvas, "cpu")


class DeviceProbe(R2V2Dataset):
    """Unpickled (in a worker), it replaces ``multihost.local_device`` by a
    refusal, ``torch.cuda.set_device`` by a record, and the decode by a
    record that decodes on the CPU; each item carries what was recorded."""

    def __setstate__(self, state):
        self.__dict__.update(state)
        multihost.local_device = _looked_up
        torch.cuda.set_device = _set_device
        native.decode_jpeg_files = _decode_files

    def __getitem__(self, idx):
        item = super().__getitem__(idx)
        return dict(item, set_device=_SEEN["set_device"], decode_devices=sorted(
            set(_SEEN["decode"])))


class RaisingDataset:
    def __len__(self):
        return 8

    def __getitem__(self, idx):
        raise OSError(f"the read of item {idx} failed")


class ExitingDataset:
    def __len__(self):
        return 8

    def __getitem__(self, idx):
        os._exit(3)
