"""``--native-decode`` with ``--loader-processes`` on the CPU, where each
spawned worker decodes with the plain version (``cv2.imdecode``, then the
resize's plain PyTorch version), and the loader's worker processes.

- (a) two iterations of the CLI from a JPEG tree with both flags: a finite
  val pass, a checkpoint, the workers' plain decodes counted in the parent,
  no cv2 read;
- (b) the loader's batches from 2 worker processes bit-equal to one
  thread's on a ``repeatable`` R2V2 tree, and the decode's counters (the
  plain decodes, the resize's plain calls) summed in the parent;
- (c) the same batches against the JAX package's loader with
  ``use_processes=True`` and ``--native-decode`` (forked workers, its
  native decoder): the other keys equal, the images within
  ``tests/test_torch_port_native_decode.py``'s tolerance for a full-scale
  decode (mean absolute difference < 1, 99th percentile <= 4);
- (d) ``EndTaskImagenetSolver`` from an ImageNet tree with both flags, 2
  iterations;
- (e) no draw repeated across two workers, for R2V2, Kinetics-400 and the
  GOT-10k pairs, read together through one pool (each worker reseeds the
  generators its copy holds);
- (f) a worker decodes on the device that the parent's loader looked up
  (``multihost.local_device`` stubbed to ``cuda:1``, built without CUDA),
  sets it, and never looks a device up;
- (g) a worker whose read raises, and one that exits, end ``get_batch``
  with an error within ``WORKER_POLL_S`` (plus the pool's start), and
  ``shutdown`` returns.

Run alone: ``JAX_PLATFORMS=cpu python -m pytest
tests/test_torch_port_native_decode_processes.py -q``.
"""

import ast
import os
import re
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import torch_port_loader_workers as workers
from torch_port_threads import one_intra_op_thread  # noqa: F401  (a module fixture)
from vince_tpu.data import loader as jloader
from vince_tpu.data import r2v2_dataset as jr2v2
from vince_tpu_torch import native, solver_runner
from vince_tpu_torch.data import loader as tloader
from vince_tpu_torch.data import r2v2_dataset as tr2v2
from vince_tpu_torch.ops.kernels.jpeg_kernels import resize_canvas
from vince_tpu_torch.parallel import multihost

SEED = 3
BATCHES = 4


def _args(tree, **kw):
    base = dict(input_width=64, input_height=64, num_frames=2, multi_frame=True, seed=SEED,
                data_path=str(tree), imagenet_data_path=str(tree), platform="cpu",
                native_decode=True)
    base.update(kw)
    return SimpleNamespace(**base)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("r2v2")
    workers.write_r2v2_tree(str(root))
    return root


def _read(loader, dataset, n=BATCHES):
    loader.set_dataset(dataset)
    try:
        return [loader.get_batch(timeout=120) for _ in range(n)]
    finally:
        loader.shutdown()


@pytest.fixture(scope="module")
def batches(tree):
    """The first batches of a ``repeatable`` R2V2 split, 2 videos a batch: from
    one thread, from 2 worker processes (with the parent's counters after
    them) and from the JAX package's 2 forked workers."""
    out = {"threads": _read(tloader.PersistentDataLoader(batch_size=2, num_workers=1, seed=7),
                            tr2v2.R2V2Dataset(_args(tree), "train", repeatable=True))}
    native.reset_counts()
    resize_canvas.plain_calls = 0
    loader = tloader.PersistentDataLoader(batch_size=2, num_workers=2, seed=7,
                                          use_processes=True)
    loader.set_dataset(tr2v2.R2V2Dataset(_args(tree), "train", repeatable=True))
    try:
        out["processes"] = [loader.get_batch(timeout=120) for _ in range(BATCHES)]
        out["counts"] = dict(native.counts), resize_canvas.plain_calls
        loader._pending[0].wait(120)  # a batch done but not taken
    finally:
        loader.shutdown()
    out["counts_at_shutdown"] = native.counts["plain"]
    out["jax"] = _read(jloader.PersistentDataLoader(batch_size=2, num_workers=2, seed=7,
                                                    use_processes=True),
                       jr2v2.R2V2Dataset(_args(tree), "train", repeatable=True))
    return out


def _cli_argv(tree, logdir, *extra):
    return ["--title", "files", "--description", "cpu", "--solver", "VinceSolver",
            "--dataset", "R2V2Dataset", "--data-path", str(tree), "--use-videos",
            "--inter-batch-comparison", "--num-frames", "2", "--batch-size", "4",
            "--backbone", "ResNet18", "--input-width", "64", "--input-height", "64",
            "--vince-queue-size", "32", "--vince-embedding-size", "16",
            "--iterations-per-epoch", "2", "--epochs", "1", "--save-frequency", "2",
            "--base-lr", "0.03", "--num-workers", "2", "--platform", "cpu", "--debug",
            "--base-logdir", str(logdir), "--native-decode", "--loader-processes", *extra]


def _val_lines(out):
    return [ast.literal_eval(line[len("val: "):]) for line in out.splitlines()
            if line.startswith("val: ")]


def test_cli_two_iterations_with_native_decode_in_worker_processes(tree, tmp_path, capsys):
    native.reset_counts()
    solver = solver_runner.main(_cli_argv(tree, tmp_path))
    val = _val_lines(capsys.readouterr().out)
    assert solver.state.step == 2
    assert len(val) == 1 and np.isfinite(list(val[0].values())).all()
    assert np.isfinite(solver.state.model.embedding.fc2.weight.detach().numpy()).all()
    assert sorted(os.listdir(tmp_path / "files" / "checkpoints_cpu")) == ["2"]
    assert native.counts["plain"] > 0 and native.counts["cv2_reads"] == 0
    assert native.counts["plain"] == native.counts["files"]


def test_process_batches_equal_the_thread_batches(batches):
    assert len(batches["processes"]) == len(batches["threads"]) == BATCHES
    for got, ref in zip(batches["processes"], batches["threads"]):
        assert set(got) == set(ref)
        for k in ref:
            np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(ref[k]), err_msg=k)
    # the workers' decodes and resizes, summed in the parent as the batches came
    counts, resizes = batches["counts"]
    assert counts["plain"] == counts["files"] == resizes > 0 and counts["cv2_reads"] == 0
    # a batch done but not taken adds its decodes at shutdown
    assert batches["counts_at_shutdown"] > counts["plain"]


def test_process_batches_agree_with_the_jax_process_loader(batches):
    for got, ref in zip(batches["processes"], batches["jax"], strict=True):
        assert set(got) == set(ref)
        for k in ref:
            if k in ("data", "queue_data"):
                assert got[k].shape == ref[k].shape and got[k].dtype == np.uint8
                d = np.abs(got[k].astype(np.int16) - ref[k].astype(np.int16))
                assert d.mean() < 1.0 and np.percentile(d, 99) <= 4, k
            else:
                np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(ref[k]),
                                              err_msg=k)


def _imagenet_tree(root):
    for split, per_class in (("train", 4), ("val", 2)):
        for c in range(2):
            for i in range(per_class):
                workers.write_jpg(os.path.join(root, split, f"n{c:08d}", f"{split}_{i}.JPEG"),
                                  100 * c + i + (50 if split == "val" else 0))


def test_end_task_imagenet_solver_with_native_decode_in_worker_processes(tmp_path, capsys):
    _imagenet_tree(str(tmp_path / "imagenet"))
    native.reset_counts()
    solver = solver_runner.main([
        "--title", "files", "--description", "in", "--solver", "EndTaskImagenetSolver",
        "--dataset", "ImagenetDataset", "--imagenet-data-path", str(tmp_path / "imagenet"),
        "--backbone", "ResNet18", "--batch-size", "4", "--input-width", "32",
        "--input-height", "32", "--vince-embedding-size", "16",
        "--end-task-classifier-num-classes", "2", "--iterations-per-epoch", "2", "--epochs",
        "1", "--base-lr", "0.1", "--num-workers", "2", "--no-restore", "--save-frequency",
        "100", "--platform", "cpu", "--debug", "--base-logdir", str(tmp_path),
        "--native-decode", "--loader-processes"])
    out = capsys.readouterr().out
    assert solver.state.step == 2
    val = [line for line in out.splitlines() if line.startswith("val")]
    assert val and "nan" not in val[-1]
    assert native.counts["plain"] > 0 and native.counts["cv2_reads"] == 0


@pytest.fixture(scope="module")
def draws(tmp_path_factory):
    """Two epochs of an R2V2 tree, a Kinetics-400 tree and a GOT-10k tree (the
    pair transform sharing the dataset's generator) through one pool of 2
    workers, 2 items a batch: the items (each with its peeked draw and pid)."""
    tmp = tmp_path_factory.mktemp("draws")
    workers.write_r2v2_tree(str(tmp / "r2v2"), splits=("train",))
    workers.write_kinetics_tree(str(tmp / "kinetics"))
    workers.write_got10k_tree(str(tmp / "got10k"))
    ds = workers.PeekAll(
        workers.PeekR2V2(_args(tmp / "r2v2", native_decode=False), "train"),
        workers.PeekKinetics(_args(tmp / "kinetics", native_decode=False), "train",
                             num_images_to_return=3),
        workers.PeekGOT10k(_args(tmp / "got10k", input_width=120, native_decode=False),
                           "train", pairs_per_seq=4),
        str(tmp_path_factory.mktemp("barrier")))
    loader = tloader.PersistentDataLoader(batch_size=2, num_workers=2, seed=7,
                                          use_processes=True, collate_fn=list)
    items = [item for batch in _read(loader, ds, n=len(ds)) for item in batch]
    return items, {part: len(getattr(ds, part)) for part in ds.PARTS}


@pytest.mark.parametrize("name,part", [("R2V2Dataset", "r2v2"),
                                       ("Kinetics400Dataset", "kinetics"),
                                       ("GOT10kDataset", "got10k")])
def test_no_draw_is_repeated_across_worker_processes(draws, name, part):
    items, sizes = draws
    pids = {int(item["pid"]) for item in items}
    assert len(pids) == 2 and os.getpid() not in pids
    mine = [int(item["draw"]) for item in items if item["part"] == part]
    assert len(mine) == 2 * sizes[part]  # two epochs
    assert len(set(mine)) == len(mine), f"{name}: a draw repeated across the workers"


def test_worker_decodes_on_the_device_the_parent_fixed(tree, monkeypatch):
    looked_up = []

    def local_device(platform):  # the parent's lookup: this rank's GPU
        looked_up.append(platform)
        return torch.device("cuda", 1)

    monkeypatch.setattr(multihost, "local_device", local_device)
    ds = workers.DeviceProbe(_args(tree, platform="cuda"), "train", repeatable=True)
    got = _read(tloader.PersistentDataLoader(batch_size=2, num_workers=2, seed=7,
                                             use_processes=True), ds, n=2)
    assert looked_up == ["cuda"]  # once, in the parent, by the loader
    assert {d for b in got for d in b["set_device"]} == {"cuda:1"}
    assert {d for b in got for ds_ in b["decode_devices"] for d in ds_} == {"cuda:1"}
    assert all(b["data"].shape == (4, 73, 73, 3) for b in got)


@pytest.mark.parametrize("dataset,match", [
    (workers.RaisingDataset, "a loader worker process failed"),
    (workers.ExitingDataset, r"a loader worker process exited \(pid \d+, exit code 3\)")])
def test_a_failed_worker_ends_get_batch(dataset, match):
    loader = tloader.PersistentDataLoader(batch_size=2, num_workers=2, seed=7,
                                          use_processes=True)
    caught, done = [], threading.Event()

    def consume():
        try:
            loader.get_batch()  # no timeout: the loader itself must end the wait
        except BaseException as exc:
            caught.append(exc)
        done.set()

    t0 = time.monotonic()
    loader.set_dataset(dataset())
    threading.Thread(target=consume, daemon=True).start()
    # the pool's start (a spawned python importing torch) and one poll
    assert done.wait(60 + tloader.WORKER_POLL_S), "get_batch still waits"
    waited = time.monotonic() - t0
    stopper = threading.Thread(target=loader.shutdown, daemon=True)
    stopper.start()
    stopper.join(tloader.KILL_WAIT_S + 30)
    assert not stopper.is_alive(), "shutdown still waits"
    (exc,) = caught
    assert isinstance(exc, RuntimeError), exc
    assert re.search(match, str(exc)), str(exc)
    if dataset is workers.RaisingDataset:
        assert isinstance(exc.__cause__, OSError)
    print(f"{dataset.__name__}: get_batch raised after {waited:.2f} s")
