"""The port's video cacher and the tools that write frame caches, against
``vince_tpu``'s, offline: videos written in the test (``chip_smoke.py``'s
generator of phase 16, at 160x96) stand in for downloads
(a stubbed ``download_video`` copies one, as the cacher removes what it is
given). At one worker, with ``random.seed(s)`` for JAX and ``random.Random(s)``
for the port, the cacher returns the same codes and writes the same files,
byte for byte; so do ``recreate_r2v2_dataset`` and ``download_kinetics``. The
cache tool skips and appends as JAX's does, and the port's ``R2V2Dataset``
and ``Kinetics400Dataset`` read what the tools write."""

import argparse
import json
import os
import random
import shutil
import types

import numpy as np
import pytest

from chip_smoke import scene_video, write_video
from torch_port_offline import offline, one_cv2_thread  # noqa: F401  (fixtures)
from torch_port_threads import one_intra_op_thread  # noqa: F401  (a module fixture)
from vince_tpu.data import video_cacher_dataset as jcacher
from vince_tpu.scrape import cache_video_dataset as jcache_tool
from vince_tpu.scrape import download_kinetics as jkinetics
from vince_tpu.scrape import recreate_r2v2_dataset as jrecreate
from vince_tpu.utils import youtube_utils as jyt
from vince_tpu_torch.data import video_cacher_dataset as tcacher
from vince_tpu_torch.scrape import cache_video_dataset as tcache_tool
from vince_tpu_torch.scrape import download_kinetics as tkinetics
from vince_tpu_torch.scrape import recreate_r2v2_dataset as trecreate
from vince_tpu_torch.utils import youtube_utils as tyt

SMALL = (40, (96, 160), 8)  # chip_smoke.scene_video's frames, (h, w), letterbox rows
# 11-character ids; "blurryVid00" is blurred past the Laplacian filter, the
# ids not in the library fail to download
IDS = ["vidAAAAAAA0", "vidBBBBBBB1", "vidCCCCCCC2", "blurryVid00", "missingVid0"]


@pytest.fixture(scope="module")
def library(tmp_path_factory):
    """The written videos by id: 40 frames of 160x96, 2-3 scenes each."""
    import cv2

    root = tmp_path_factory.mktemp("library")
    out = {}
    for seed, vid in enumerate(IDS[:4]):
        frames = scene_video(seed, *SMALL)
        if vid.startswith("blurry"):
            frames = [cv2.GaussianBlur(f, (0, 0), 2.0) for f in frames]
        out[vid] = write_video(root / f"{vid}.avi", frames, 30)
    return out


@pytest.fixture
def downloads(monkeypatch, tmp_path, library):
    """Both packages' ``download_video`` copy the library's video to a fresh
    path (None for an id it lacks); the ids asked for, in order."""
    asked = []

    def download(video_id, *args, **kwargs):
        asked.append(video_id)
        if video_id not in library:
            return None
        dest = tmp_path / "downloads" / f"{len(asked)}_{video_id}.avi"
        dest.parent.mkdir(exist_ok=True)
        return shutil.copy(library[video_id], dest)

    for mod in (tyt, jyt):
        monkeypatch.setattr(mod, "download_video", download)
    return asked


def _files(root):
    return {os.path.relpath(os.path.join(dp, f), root): open(os.path.join(dp, f), "rb").read()
            for dp, _, fs in os.walk(root) for f in fs}


OPTIONS = {
    "default": dict(args={}, kw={}),
    "shots": dict(args={"only_use_shots": True, "video_sample_rate": 1}, kw={}),
    "flow": dict(args={}, kw={"filter_using_flow": True}),
    "window": dict(args={"max_video_length": 5, "video_sample_rate": 1}, kw={}),
    "shots, 6 frames, rate 2": dict(args={"only_use_shots": True, "video_sample_rate": 2},
                                    kw={"num_frames_to_cache": 6}),
    "max side 64, no dedup": dict(args={"max_side_size": 64},
                                  kw={"filter_similar_frames": False}),
}


@pytest.mark.parametrize("option", list(OPTIONS))
def test_cacher_writes_what_jax_writes(tmp_path, downloads, option):
    spec = OPTIONS[option]
    args = argparse.Namespace(**spec["args"])
    results = {}
    for label, mod in (("port", tcacher), ("jax", jcacher)):
        out = tmp_path / label
        kw = dict(spec["kw"])
        if label == "port":
            kw["rng"] = random.Random(5)
        else:
            random.seed(5)
        ds = mod.VideoCacherDataset(args, IDS, str(out), **kw)
        codes = [ds[i] for i in range(len(ds))]
        results[label] = (codes, _files(out))
    assert results["port"] == results["jax"]
    codes, files = results["port"]
    assert dict(codes)["missingVid0"] == 1 and dict(codes)["blurryVid00"] == 2
    assert sorted({name.split("/")[0] for name in files}) == ["vi"]
    assert files and all(name.endswith(".jpg") for name in files)
    assert not os.listdir(tmp_path / "downloads")  # each download removed
    if option == "shots":  # a cached shot per run of frames long enough
        assert len(files) > 4 * sum(code == 0 for _, code in codes)


def test_cacher_codes_three_when_no_shot_is_long_enough(tmp_path, downloads):
    args = argparse.Namespace(only_use_shots=True, video_sample_rate=4)
    got = tcacher.VideoCacherDataset(args, IDS[:3], str(tmp_path / "port"),
                                     num_frames_to_cache=6, rng=random.Random(0))
    random.seed(0)
    ref = jcacher.VideoCacherDataset(args, IDS[:3], str(tmp_path / "jax"), num_frames_to_cache=6)
    codes = [got[i] for i in range(3)]
    assert codes == [ref[i] for i in range(3)]
    assert 3 in dict(codes).values()


def test_cacher_draws_from_the_seed_by_default(tmp_path, downloads):
    args = argparse.Namespace(seed=3, max_video_length=5, video_sample_rate=1)
    a = tcacher.VideoCacherDataset(args, IDS[:3], str(tmp_path / "a"))
    b = tcacher.VideoCacherDataset(args, IDS[:3], str(tmp_path / "b"), rng=random.Random(3))
    assert [a[i] for i in range(3)] == [b[i] for i in range(3)]
    assert _files(tmp_path / "a") == _files(tmp_path / "b")


class FakeCacher:
    seen = []

    def __init__(self, args, ids, output, **kw):
        self.ids = list(ids)

    def __len__(self):
        return len(self.ids)

    def __getitem__(self, i):
        FakeCacher.seen.append(self.ids[i])
        return self.ids[i], {"vidC": 0, "vidD": 1, "vidE": 2, "vidF": 3}[self.ids[i]]


def test_cache_tool_skips_and_appends_as_jax_does(tmp_path, monkeypatch):
    """Known-failed and cached ids are skipped (the shard directories are
    scanned); failed downloads and filtered-out ids are appended."""
    csv_path = tmp_path / "ids.csv"
    csv_path.write_text("vidA,x\nvidB\n\nvidC\nvidD\nvidE\nvidF\n")
    out = {}
    for label, mod in (("port", tcache_tool), ("jax", jcache_tool)):
        root = tmp_path / label
        (root / "vi").mkdir(parents=True)
        (root / "failed_video_ids.txt").write_text("vidA\n")
        (root / "vi" / "vidB_000001.jpg").write_bytes(b"")
        monkeypatch.setattr(mod, "VideoCacherDataset", FakeCacher)
        FakeCacher.seen = []
        mod.main(["--csv-path", str(csv_path), "--output-path", str(root), "--num-workers", "2"])
        first = sorted(FakeCacher.seen)
        FakeCacher.seen = []
        mod.main(["--csv-path", str(csv_path), "--output-path", str(root), "--num-workers", "1"])
        out[label] = (first, sorted(FakeCacher.seen), _files(root))
    assert out["port"] == out["jax"]
    first, second, files = out["port"]
    assert first == ["vidC", "vidD", "vidE", "vidF"]
    assert second == ["vidC"]  # wrote no frames, so it is tried again
    assert files["failed_video_ids.txt"] == b"vidA\nvidD\n"
    assert files["no_images_video_ids.txt"] == b"vidE\nvidF\n"


def test_cache_tool_caches_the_videos_and_skips_them_after(tmp_path, downloads):
    """The cache tool with the cacher on two workers: the ids that cache, fail
    and filter out, the frames per video; a second run downloads nothing."""
    csv_path = tmp_path / "ids.csv"
    csv_path.write_text("".join(f"{v}\n" for v in IDS))
    out = {}
    for label, mod in (("port", tcache_tool), ("jax", jcache_tool)):
        root = tmp_path / label
        argv = ["--csv-path", str(csv_path), "--output-path", str(root), "--num-workers", "2",
                "--video-sample-rate", "2"]
        mod.main(argv)
        files = _files(root)
        per_video = {}
        for name in files:
            if name.endswith(".jpg"):
                vid = os.path.basename(name).rsplit("_", 1)[0]
                per_video[vid] = per_video.get(vid, 0) + 1
        downloads.clear()
        mod.main(argv)
        out[label] = (per_video, files["failed_video_ids.txt"],
                      files["no_images_video_ids.txt"], list(downloads))
    assert out["port"] == out["jax"]
    per_video, failed, no_images, again = out["port"]
    assert per_video == {v: 4 for v in IDS[:3]}
    assert failed == b"missingVid0\n" and no_images == b"blurryVid00\n"
    assert again == []


def test_cached_frames_feed_the_port_r2v2_dataset(tmp_path, downloads):
    from vince_tpu_torch.data.r2v2_dataset import R2V2Dataset

    csv_path = tmp_path / "ids.csv"
    csv_path.write_text("".join(f"{v}\n" for v in IDS))
    tcache_tool.main(["--csv-path", str(csv_path), "--output-path", str(tmp_path / "r2v2" / "train"),
                  "--num-workers", "1", "--only-use-shots"])
    args = types.SimpleNamespace(data_path=str(tmp_path / "r2v2"), num_frames=2, input_width=32,
                                 multi_frame=True)
    ds = R2V2Dataset(args, "train", check_for_new_data=True)
    assert sorted(vid for vid, _ in ds.index.path_info) == IDS[:3]
    for vid, frames in ds.index.path_info:
        assert len(frames) >= 4 and len(vid) == 11
    item = ds[0]
    assert item["data"].shape == (2, ds.canvas, ds.canvas, 3) and item["data"].dtype == np.uint8
    assert item["queue_data"].shape == item["data"].shape


def _seek_lines(library):
    return [f"{IDS[0]},0,7,19,33\n", f"{IDS[1]},2,3,39\n", f"{IDS[2]},5,45\n",  # 45: past the end
            f"{IDS[4]},1,2\n", "badline\n"]


def test_recreate_r2v2_matches_jax(tmp_path, downloads, library):
    ids_file = tmp_path / "r2v2_ids.txt"
    ids_file.write_text("".join(_seek_lines(library)) + "\n")
    out = {}
    for label, mod in (("port", trecreate), ("jax", jrecreate)):
        root = tmp_path / label
        downloads.clear()
        mod.main(["--ids-file", str(ids_file), "--output-path", str(root), "--num-workers", "1",
                  "--max-side-size", "128"])
        first = list(downloads)
        downloads.clear()
        mod.main(["--ids-file", str(ids_file), "--output-path", str(root), "--num-workers", "2"])
        out[label] = (_files(root), first, sorted(downloads))
    assert out["port"] == out["jax"]
    files, first, second = out["port"]
    assert sorted(files) == sorted(
        [f"vi/{IDS[0]}_{f:06d}.jpg" for f in (0, 7, 19, 33)]
        + [f"vi/{IDS[1]}_{f:06d}.jpg" for f in (2, 3, 39)] + [f"vi/{IDS[2]}_000005.jpg"])
    assert first == [IDS[0], IDS[1], IDS[2], IDS[4]]
    # the second run skips the videos whose frames all exist
    assert second == sorted([IDS[2], IDS[4]])


def test_recreated_frames_are_the_seek_decoded_frames(tmp_path, downloads, library):
    """Each JPEG decodes to the pixels of cv2's seek-decode of its frame,
    written by cv2.imwrite."""
    import cv2

    trecreate.recreate_video(f"{IDS[0]},0,12,25", str(tmp_path / "r"))
    cap = cv2.VideoCapture(library[IDS[0]])
    for f in (0, 12, 25):
        cap.set(cv2.CAP_PROP_POS_FRAMES, f)
        ok, frame = cap.read()
        assert ok
        cv2.imwrite(str(tmp_path / "want.jpg"), frame)
        np.testing.assert_array_equal(
            cv2.imread(str(tmp_path / "r" / "vi" / f"{IDS[0]}_{f:06d}.jpg")),
            cv2.imread(str(tmp_path / "want.jpg")))
    cap.release()


def test_download_kinetics_matches_jax_and_feeds_the_dataset(tmp_path, downloads):
    from vince_tpu_torch.data.kinetics_dataset import Kinetics400Dataset

    ann = {IDS[0]: {"annotations": {"label": "abseiling", "segment": [0.2, 0.9]}},
           IDS[1]: {"annotations": {"label": "zumba", "segment": [0.0, 1.2]}},
           IDS[2]: {"annotations": {"label": "abseiling"}},  # default segment [0, 10]
           IDS[4]: {"annotations": {"label": "zumba", "segment": [1, 2]}}}
    for label, mod in (("port", tkinetics), ("jax", jkinetics)):
        (tmp_path / label / "annotations").mkdir(parents=True)
        (tmp_path / label / "annotations" / "train.json").write_text(json.dumps(ann))
        mod.main(["--annotation-json", str(tmp_path / label / "annotations" / "train.json"),
                  "--output-path", str(tmp_path / label / "train"), "--num-workers", "2",
                  "--fps", "10", "--max-side-size", "120"])
    files = _files(tmp_path / "port" / "train")
    assert files == _files(tmp_path / "jax" / "train")
    counts = {vid: sum(name.startswith(f"vi/{vid}_") for name in files) for vid in IDS[:3]}
    assert counts == {IDS[0]: 7, IDS[1]: 12, IDS[2]: 14}  # 40 frames at 30 fps: 1.33 s
    args = types.SimpleNamespace(data_path=str(tmp_path / "port"), num_frames=4, input_width=32,
                                 seed=0)
    ds = Kinetics400Dataset(args, "train", check_for_new_data=True)
    assert len(ds) == 3
    item = ds[1]
    assert item["data"].shape == (4, ds.canvas, ds.canvas, 3)
    assert int(item["labels"]) == 1  # zumba after abseiling
