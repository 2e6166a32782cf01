"""The port's file-backed datasets against ``vince_tpu.data`` on the same small
trees, written in ``tmp_path`` with ``cv2`` from a numpy seed (the layouts
of ``tests/test_file_datasets.py``): R2V2 and its GOT-10k layout, ImageNet,
SUN-397 and Kinetics-400. Each dataset's index, class map, labels and item
arrays are bit-equal to JAX's: ``repeatable`` items by their index, the
others with numpy's global generator seeded for JAX as the port seeds its
own ``RandomState(--seed)``. Also ``--no-multi-frame``,
``num_data_points``, a bad file giving ``None``, and ``--native-decode``'s
plain version against the ``cv2`` read."""

import json
import os
from types import SimpleNamespace

import cv2
import numpy as np
import pytest

from vince_tpu.data import imagenet_dataset as jim
from vince_tpu.data import kinetics_dataset as jkin
from vince_tpu.data import r2v2_dataset as jr2v2
from vince_tpu_torch import native
from vince_tpu_torch.data import imagenet_dataset as tim
from vince_tpu_torch.data import kinetics_dataset as tkin
from vince_tpu_torch.data import r2v2_dataset as tr2v2
from torch_port_threads import one_intra_op_thread  # noqa: F401  (a module fixture)

SEED = 5


def _args(tmp, **kw):
    base = dict(input_width=32, input_height=32, num_frames=2, multi_frame=True, seed=SEED,
                data_path=str(tmp), imagenet_data_path=str(tmp), platform="cpu")
    base.update(kw)
    return SimpleNamespace(**base)


def _write_jpg(path, seed, shape=(48, 64)):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    img = cv2.resize(np.random.RandomState(seed).randint(0, 256, (6, 8, 3), np.uint8),
                     shape[::-1], interpolation=cv2.INTER_CUBIC)
    assert cv2.imwrite(path, img)


def _r2v2_tree(root, layout="r2v2"):
    """Three videos of 5 frames and one of 1 (left out by the min-frames filter)."""
    for v, vid in enumerate(("AAvidone0000", "ABvidtwo0000", "ACthree00000", "AAshort00000")):
        for f in range(1 if "short" in vid else 5):
            path = (os.path.join(root, "train", vid[:2], f"{vid}_{f:06d}.jpg") if layout == "r2v2"
                    else os.path.join(root, "train", vid, f"{f + 1:08d}.jpg"))
            _write_jpg(path, 10 * v + f)


def _items_equal(got, ref):
    if ref is None:
        assert got is None
        return
    assert set(got) == set(ref)
    for k in ref:
        if isinstance(ref[k], np.ndarray):
            assert got[k].dtype == ref[k].dtype, k
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


def _draw_all(ds, global_seed=None):
    if global_seed is not None:
        np.random.seed(global_seed)
    return [ds[i] for i in range(len(ds))]


@pytest.mark.parametrize("repeatable", [True, False])
@pytest.mark.parametrize("multi_frame", [True, False])
@pytest.mark.parametrize("cls", ["R2V2Dataset", "GOT10KR2V2Dataset"])
def test_r2v2_items_are_bit_equal(tmp_path, cls, multi_frame, repeatable):
    _r2v2_tree(str(tmp_path), "r2v2" if cls == "R2V2Dataset" else "got10k")
    args = _args(tmp_path, multi_frame=multi_frame)
    ref_ds = getattr(jr2v2, cls)(args, "train", num_images_to_return=3, repeatable=repeatable)
    got_ds = getattr(tr2v2, cls)(args, "train", num_images_to_return=3, repeatable=repeatable)
    assert len(got_ds) == len(ref_ds) == 3
    assert got_ds.index.path_info == ref_ds.index.path_info
    ref = _draw_all(ref_ds, None if repeatable else SEED)
    got = _draw_all(got_ds)
    for g, r in zip(got, ref):
        _items_equal(g, r)
        assert g["data"].shape == (3, 36, 36, 3)
        if not multi_frame:  # every pair from one frame
            assert (g["data"] == g["data"][:1]).all() and (g["queue_data"] == g["data"]).all()


def test_r2v2_val_split_draws_from_seed_plus_one(tmp_path):
    for f in range(4):
        _write_jpg(os.path.join(str(tmp_path), "val", "AA", f"AAvid_{f:06d}.jpg"), f)
    args = _args(tmp_path)
    ref_ds = jr2v2.R2V2Dataset(args, "val")
    got_ds = tr2v2.R2V2Dataset(args, "val")
    _items_equal(_draw_all(got_ds)[0], _draw_all(ref_ds, SEED + 1)[0])


@pytest.mark.parametrize("num_data_points", [None, 3])
@pytest.mark.parametrize("num_frames", [1, 2])
def test_imagenet_items_are_bit_equal(tmp_path, num_frames, num_data_points):
    for c, (wnid, n) in enumerate((("n01440764", 2), ("n01443537", 3))):
        for i in range(n):
            _write_jpg(os.path.join(str(tmp_path), "train", wnid, f"img_{i}.JPEG"), 10 * c + i)
    os.makedirs(tmp_path / "train" / "n00000000_empty")  # a class with no image
    args = _args(tmp_path, num_frames=num_frames)
    ref_ds = jim.ImagenetDataset(args, "train", num_data_points=num_data_points)
    got_ds = tim.ImagenetDataset(args, "train", num_data_points=num_data_points)
    assert got_ds.class_to_idx == ref_ds.class_to_idx
    assert got_ds.samples == ref_ds.samples
    assert len(got_ds) == (num_data_points or 5)
    for g, r in zip(_draw_all(got_ds), _draw_all(ref_ds)):
        _items_equal(g, r)
        assert g["data"].shape == (num_frames, 36, 36, 3)


@pytest.mark.parametrize("subset", ["train", "val"])
def test_sun_scene_items_are_bit_equal(tmp_path, subset):
    rels = ["/a/abbey/sun_001.jpg", "/a/abbey/sun_002.jpg", "/b/beach/sun_003.jpg",
            "/b/bar/sun_004.jpg"]
    for i, r in enumerate(rels):
        _write_jpg(str(tmp_path) + r, i)
    name = "Training_01.txt" if subset == "train" else "Testing_01.txt"
    (tmp_path / name).write_text("\n".join(rels[::-1] if subset == "val" else rels) + "\n\n")
    args = _args(tmp_path)
    ref_ds, got_ds = jim.SunSceneDataset(args, subset), tim.SunSceneDataset(args, subset)
    assert got_ds.class_to_idx == ref_ds.class_to_idx
    assert got_ds.samples == ref_ds.samples
    for g, r in zip(_draw_all(got_ds), _draw_all(ref_ds)):
        _items_equal(g, r)


def _kinetics_tree(root):
    vids = ["AAclipone000", "ABcliptwo000", "ACclipthree0"]
    for v, vid in enumerate(vids):
        for f in range(6):
            _write_jpg(os.path.join(root, "train", vid[:2], f"{vid}_{f:06d}.jpg"), 10 * v + f)
    os.makedirs(os.path.join(root, "annotations"))
    with open(os.path.join(root, "annotations", "train.json"), "w") as f:
        json.dump({vid: {"annotations": {"label": label}}
                   for vid, label in zip(vids, ("juggling", "archery", "juggling"))}, f)
    return vids


def test_kinetics_labels_and_windows_are_bit_equal(tmp_path):
    vids = _kinetics_tree(str(tmp_path))
    args = _args(tmp_path)
    ref_ds = jkin.Kinetics400Dataset(args, "train", num_images_to_return=3)
    assert (tmp_path / "annotations" / "train.pkl").exists()
    # the port reads the label map that JAX pickled, and builds the same one anew
    got_ds = tkin.Kinetics400Dataset(args, "train", num_images_to_return=3)
    rebuilt = tkin.Kinetics400Dataset(args, "train", num_images_to_return=3,
                                      check_for_new_data=True)
    assert got_ds.annotations == rebuilt.annotations == ref_ds.annotations
    assert got_ds.annotations == {vids[0]: 1, vids[1]: 0, vids[2]: 1}
    assert got_ds.index.path_info == ref_ds.index.path_info
    ref, got = _draw_all(ref_ds, SEED), _draw_all(got_ds)
    for g, r in zip(got, ref):
        _items_equal(g, r)
        assert g["data"].shape == (3, 36, 36, 3)


@pytest.mark.parametrize("kind", ["r2v2", "imagenet", "sun", "kinetics"])
def test_a_bad_file_gives_none(tmp_path, kind):
    """A file that is not an image makes its item None on both sides (the
    loader then draws another), with and without ``--native-decode``."""
    root = str(tmp_path)
    if kind == "r2v2":
        _r2v2_tree(root)
        bad = os.path.join(root, "train", "AA", "AAvidone0000_000000.jpg")
        make = lambda pkg, a: pkg.R2V2Dataset(a, "train", repeatable=True)  # noqa: E731
        pkgs = (jr2v2, tr2v2)
    elif kind == "imagenet":
        bad = os.path.join(root, "train", "n01", "img_0.JPEG")
        _write_jpg(bad, 0)
        make = lambda pkg, a: pkg.ImagenetDataset(a, "train")  # noqa: E731
        pkgs = (jim, tim)
    elif kind == "sun":
        bad = os.path.join(root, "a", "abbey", "sun_001.jpg")
        _write_jpg(bad, 0)
        (tmp_path / "Training_01.txt").write_text("/a/abbey/sun_001.jpg\n")
        make = lambda pkg, a: pkg.SunSceneDataset(a, "train")  # noqa: E731
        pkgs = (jim, tim)
    else:
        _kinetics_tree(root)
        bad = os.path.join(root, "train", "AA", "AAclipone000_000000.jpg")
        make = lambda pkg, a: pkg.Kinetics400Dataset(  # noqa: E731
            a, "train", num_images_to_return=6)
        pkgs = (jkin, tkin)
    with open(bad, "wb") as f:
        f.write(b"not an image")
    for native_decode in (False, True):
        args = _args(tmp_path, native_decode=native_decode)
        ref, got = make(pkgs[0], args)[0], make(pkgs[1], args)[0]
        assert ref is None and got is None


@pytest.mark.parametrize("kind", ["r2v2", "sun"])
def test_native_decode_items_match_the_cv2_read(tmp_path, kind):
    """``--native-decode`` on the CPU (cv2's decode and the resize's plain
    version) gives each item's arrays within 1 of the cv2 read, and counts
    no cv2 read; a PNG in the tree takes the cv2 read and is counted."""
    if kind == "r2v2":
        _r2v2_tree(str(tmp_path))
        make = lambda a: tr2v2.R2V2Dataset(a, "train", repeatable=True)  # noqa: E731
    else:
        rels = ["/a/abbey/sun_001.jpg", "/b/beach/sun_002.png"]
        for i, r in enumerate(rels):
            os.makedirs(os.path.dirname(str(tmp_path) + r), exist_ok=True)
            cv2.imwrite(str(tmp_path) + r, np.random.RandomState(i).randint(
                0, 256, (40, 56, 3), np.uint8))
        (tmp_path / "Training_01.txt").write_text("\n".join(rels))
        make = lambda a: tim.SunSceneDataset(a, "train")  # noqa: E731
    ref = _draw_all(make(_args(tmp_path)))
    native.reset_counts()
    got = _draw_all(make(_args(tmp_path, native_decode=True)))
    for g, r in zip(got, ref):
        assert set(g) == set(r)
        d = np.abs(g["data"].astype(np.int16) - r["data"].astype(np.int16))
        assert d.max() <= 1 and g["data"].shape == r["data"].shape
    assert native.counts["cv2_reads"] == (1 if kind == "sun" else 0)
    assert native.counts["plain"] > 0
