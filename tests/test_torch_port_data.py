"""The port's datasets and loader against ``vince_tpu.data``: items of every
synthetic family are bit-equal for the same arguments and index; loader
batches are bit-equal with one worker in ``repeatable`` mode, across an epoch
reshuffle and over two shards; the NPZ datasets and ``collate_video_batch``
agree. Also the port's staging on the CPU, the thumbnail ring, and a loader
thread's failure reaching the consumer."""

import argparse
import itertools

import numpy as np
import pytest
import torch

from vince_tpu.data import loader as jloader
from vince_tpu.data import npz_dataset as jnpz
from vince_tpu.data import synthetic_dataset as jsyn
from vince_tpu.ops.queue import HostImageRing as JaxRing
from vince_tpu_torch.data import get_dataset
from vince_tpu_torch.data import loader as tloader
from vince_tpu_torch.data import npz_dataset as tnpz
from vince_tpu_torch.data import synthetic_dataset as tsyn
from vince_tpu_torch.data.prefetch import BatchPrefetcher, pull_with_kill, ready, stage
from vince_tpu_torch.ops.queue import HostImageRing
from torch_port_threads import one_intra_op_thread  # noqa: F401  (a module fixture)

FAMILIES = ["SyntheticVideoDataset", "SyntheticTextureVideoDataset", "SyntheticImageDataset",
            "SyntheticClipDataset", "SyntheticTextureImageDataset",
            "SyntheticTextureClipDataset"]


def _args(repeatable=True, **kw):
    return argparse.Namespace(input_width=32, num_frames=2, end_task_classifier_num_classes=0,
                              repeatable=repeatable, **kw)


def _assert_items_equal(got, ref):
    assert set(got) == set(ref)
    for k in ref:
        if isinstance(ref[k], np.ndarray):
            assert got[k].dtype == ref[k].dtype, k
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


@pytest.mark.parametrize("subset", ["train", "val"])
@pytest.mark.parametrize("repeatable", [True, False])
@pytest.mark.parametrize("family", FAMILIES)
def test_synthetic_items_are_bit_equal(family, repeatable, subset):
    kw = {"num_videos": 12} if "Video" in family else {}
    ref_ds = getattr(jsyn, family)(_args(repeatable), subset, **kw)
    got_ds = getattr(tsyn, family)(_args(repeatable), subset, **kw)
    assert len(got_ds) == len(ref_ds)
    for idx in (0, 5, len(ref_ds) - 1):
        # the items that are not repeatable draw their jitter from numpy's
        # global generator: the same state on both sides
        np.random.seed(idx)
        ref = ref_ds[idx]
        np.random.seed(idx)
        got = got_ds[idx]
        _assert_items_equal(got, ref)


def test_get_dataset_refuses_the_file_backed_datasets():
    """None of the file-backed datasets is refused: the five readers and the
    video cacher are the port's classes; an unknown name is refused."""
    assert get_dataset("SyntheticTextureVideoDataset") is tsyn.SyntheticTextureVideoDataset
    for name in ("R2V2Dataset", "GOT10KR2V2Dataset", "ImagenetDataset", "SunSceneDataset",
                 "Kinetics400Dataset", "VideoCacherDataset"):
        assert get_dataset(name).__name__ == name
        assert get_dataset(name).__module__.startswith("vince_tpu_torch.data.")
    cacher = get_dataset("VideoCacherDataset")
    assert cacher.__module__ == "vince_tpu_torch.data.video_cacher_dataset"
    with pytest.raises(KeyError, match="unknown dataset"):
        get_dataset("YouTubeDataset")


def _batches(module, dataset, n, **kw):
    loader = module.PersistentDataLoader(batch_size=3, num_workers=1, seed=7, **kw)
    loader.set_dataset(dataset)
    try:
        return [loader.get_batch(timeout=30) for _ in range(n)]
    finally:
        loader.shutdown()


@pytest.mark.parametrize("shards", [(1, 0), (2, 0), (2, 1)], ids=["one", "shard0of2", "shard1of2"])
def test_loader_batches_are_bit_equal(shards):
    """Eight videos in batches of three: the third batch crosses into the
    second epoch's permutation (with two shards of four, the second batch)."""
    num_shards, shard_id = shards
    ds_args = dict(num_videos=8, num_images_to_return=2)
    ref = _batches(jloader, jsyn.SyntheticTextureVideoDataset(_args(), **ds_args), 5,
                   num_shards=num_shards, shard_id=shard_id)
    got = _batches(tloader, tsyn.SyntheticTextureVideoDataset(_args(), **ds_args), 5,
                   num_shards=num_shards, shard_id=shard_id)
    seen = [tuple(b["ind"]) for b in got]
    assert len(set(itertools.chain(*seen))) > 8 // num_shards - 1  # the epoch turned over
    for g, r in zip(got, ref):
        _assert_items_equal(g, r)
        assert g["data"].shape == (6, 36, 36, 3)


def test_collate_video_batch_matches():
    rng = np.random.RandomState(0)
    items = [{"data": rng.randint(0, 255, (2, 4, 4, 3), np.uint8),
              "map": rng.rand(4, 4).astype(np.float32),
              "labels": np.repeat(np.int32(i), 2), "ind": np.int64(i), "id": f"v{i}"}
             for i in range(3)]
    got, ref = tloader.collate_video_batch(items), jloader.collate_video_batch(items)
    assert got.keys() == ref.keys()
    for k in ref:
        if k == "id":
            assert got[k] == ref[k]
        else:
            np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
            assert got[k].dtype == ref[k].dtype


@pytest.fixture(scope="module")
def npz_file(tmp_path_factory):
    """An NCHW uint8 file of 40x40 images (a resize to the input size) and one
    of 32x32 NHWC images (none), 23 images each."""
    tmp = tmp_path_factory.mktemp("npz")
    rng = np.random.RandomState(3)
    np.savez(tmp / "nchw_train.npz", data=rng.randint(0, 255, (23, 3, 40, 40), np.uint8),
             labels=rng.randint(0, 5, 23))
    np.savez(tmp / "nhwc_train.npz", data=rng.randint(0, 255, (23, 32, 32, 3), np.uint8),
             labels=rng.randint(0, 5, 23))
    return tmp


@pytest.mark.parametrize("layout", ["nchw", "nhwc"])
@pytest.mark.parametrize("subset_size", [None, 10])
def test_npz_dataset_matches(npz_file, layout, subset_size):
    args = _args(input_height=32, batch_size=8)
    path = str(npz_file / f"{layout}_{{data_subset}}.npz")
    got = tnpz.NPZDataset(args, path, "train", subset_size)
    ref = jnpz.NPZDataset(args, path, "train", subset_size)
    np.testing.assert_array_equal(got.data, ref.data)
    np.testing.assert_array_equal(got.labels, ref.labels)
    for (cg, lg, vg), (cr, lr, vr) in zip(got.iter_batches(), ref.iter_batches(), strict=True):
        np.testing.assert_array_equal(cg, cr)
        np.testing.assert_array_equal(lg, lr)
        assert vg == vr


def test_npz_image_dataset_matches(npz_file):
    args = _args(cifar_data_path=str(npz_file / "nchw_{data_subset}.npz"), data_path="")
    got, ref = tnpz.NPZImageDataset(args, "train"), jnpz.NPZImageDataset(args, "train")
    assert len(got) == len(ref) == 23
    for idx in (0, 22):
        _assert_items_equal(got[idx], ref[idx])


def test_prefetcher_stages_the_loader_batches_in_order_on_the_cpu():
    """On the CPU a staged tensor shares its array's memory and has no event;
    the prefetch thread hands the loader's batches on in their order."""
    make = lambda: tsyn.SyntheticTextureVideoDataset(_args(), num_videos=8,  # noqa: E731
                                                     num_images_to_return=2)
    direct = _batches(tloader, make(), 4)
    loader = tloader.PersistentDataLoader(batch_size=3, num_workers=1, seed=7)
    loader.set_dataset(make())
    dev = torch.device("cpu")

    def stage_fn(stop):
        hb = pull_with_kill(loader, stop)
        if hb is None:
            return None
        return stage([{k: hb[k] for k in ("data", "queue_data")}], dev), hb

    prefetcher = BatchPrefetcher(stage_fn).start()
    try:
        for ref in direct:
            staged, hb = prefetcher.get(timeout=30)
            (tensors,) = ready(staged, dev)
            assert staged.event is None and tensors["data"].dtype == torch.uint8
            assert np.shares_memory(tensors["data"].numpy(), hb["data"])
            _assert_items_equal(hb, ref)
    finally:
        prefetcher.stop()
        loader.shutdown()
    assert not prefetcher.running


class _FailingDataset:
    """Items that raise, as a decode on a card that fails does."""

    def __len__(self):
        return 6

    def __getitem__(self, idx):
        raise OSError(f"the card failed on item {idx}")


def test_loader_hands_a_thread_failure_to_the_consumer():
    """A thread whose read raises ends, and the consumer's next get_batch
    raises with that exception as its cause, instead of waiting for good."""
    loader = tloader.PersistentDataLoader(batch_size=3, num_workers=2, seed=7)
    loader.set_dataset(_FailingDataset())
    try:
        with pytest.raises(RuntimeError, match="a loader thread failed") as info:
            loader.get_batch(timeout=30)
        assert isinstance(info.value.__cause__, OSError)
    finally:
        loader.shutdown()


def test_host_image_ring_matches():
    rng = np.random.RandomState(0)
    imgs = [rng.randint(0, 255, (4, 4, 3), np.uint8) for _ in range(7)]
    got, ref = HostImageRing(5), JaxRing(5)
    for ring in (got, ref):
        ring.fill_repeat(imgs[:2], ["IN", "YT"])
        ring.enqueue(imgs[2:6], "YT")
        ring.enqueue(imgs[6:], "IN")
    assert got.tail == ref.tail
    assert got.sources == ref.sources
    for g, r in zip(got.images, ref.images):
        np.testing.assert_array_equal(g, r)
    got.clear(tail=7)
    ref.clear(tail=7)
    assert (got.tail, got.images, got.sources) == (ref.tail, ref.images, ref.sources)


def test_loader_in_processes_gives_the_thread_loader_batches_and_shuts_down():
    """Worker processes (spawned) read the same indices in the same order as
    one thread; ``shutdown`` returns while jobs are in flight."""
    ds_args = dict(num_videos=8, num_images_to_return=2)
    ref = _batches(jloader, jsyn.SyntheticTextureVideoDataset(_args(), **ds_args), 4)
    loader = tloader.PersistentDataLoader(batch_size=3, num_workers=2, seed=7,
                                          use_processes=True)
    loader.set_dataset(tsyn.SyntheticTextureVideoDataset(_args(), **ds_args))
    try:
        got = [loader.get_batch(timeout=60) for _ in range(4)]
    finally:
        loader.shutdown()
    assert loader._pool is None
    for g, r in zip(got, ref, strict=True):
        _assert_items_equal(g, r)
