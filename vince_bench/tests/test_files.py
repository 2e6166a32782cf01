"""The ``files`` traffic rehearsed on the CPU at a tiny size: a JPEG tree
written from the seed, the training command's solver over it with its
loader, the compared iterations, the window with ``data_wait_ms``, the
frames held to the benchmark's own reading; and a frame altered in the
loader turns ``correct`` false."""

import time

import numpy as np
import torch

from vince_bench import harness, traffic

import tiny

LIMITS = dict(harness.limits("r18.step"), frames=0.0)


def _run(flags):
    mix = dict(traffic.load("files_cv2"), videos=12, val_videos=4, width=64, height=48,
               writers=2, flags=flags)
    return harness.runner("files").run(tiny.config("vince-r18"), mix, 2**31 + 29, 0.5, True,
                                       torch.device("cpu"), LIMITS, time.perf_counter())


def test_a_run_from_files():
    out = _run(["--loader-processes", "--num-workers", "2"])
    assert out.correct, out.compared
    assert out.compared["frames"]["value"] == 0.0
    wait = harness.reader("data_wait_ms").read(out.records)
    assert wait is not None and wait >= 0.0
    assert len(out.records.counters["data_wait_ms"]) == out.attempted


def test_an_altered_frame_is_not_correct(monkeypatch):
    from vince_tpu_torch.data.r2v2_dataset import R2V2Dataset

    read = R2V2Dataset.read_images

    def altered(self, paths):
        images = read(self, paths)
        return [np.where(img == 0, 1, img - 1).astype(np.uint8) if i == 0 else img
                for i, img in enumerate(images)]

    monkeypatch.setattr(R2V2Dataset, "read_images", altered)
    out = _run(["--num-workers", "1"])  # a thread: the patch reaches the loader
    assert not out.correct
    assert out.compared["frames"]["value"] > 0
