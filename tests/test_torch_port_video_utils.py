"""The port's frame reads, filters, class tables, info files and YouTube
command lines against ``vince_tpu``'s: the same ``cv2`` and numpy calls on
the same frames and the same video (written from a seed by ``chip_smoke.py``'s
generator of phase 16, at 160x96), so every result is held exactly, and every
file byte for byte."""

import filecmp
import os
import shutil
import subprocess

import numpy as np
import pytest

from chip_smoke import scene_video, write_video
from torch_port_offline import offline, one_cv2_thread  # noqa: F401  (fixtures)
from torch_port_threads import one_intra_op_thread  # noqa: F401  (a module fixture)
from vince_tpu.utils import util_functions as jutil
from vince_tpu.utils import video_utils as jvu
from vince_tpu.utils import youtube_utils as jyt
from vince_tpu_torch.utils import util_functions as tutil
from vince_tpu_torch.utils import video_utils as tvu
from vince_tpu_torch.utils import youtube_utils as tyt

SMALL = (40, (96, 160), 8)  # chip_smoke.scene_video's frames, (h, w), letterbox rows
INFO_FILES = ("imagenet_classes.txt", "kinetics_400_classes.txt", "sun_scene_classes.txt",
              "yt8m_classes.txt", "full_imagenet_categories.txt", "r2v2_ids_val.txt",
              "r2v2_drive_urls.txt")


@pytest.fixture(scope="module")
def video(tmp_path_factory):
    """40 frames of 160x96, three scenes, MJPG: the written path."""
    path = tmp_path_factory.mktemp("video") / "clip.avi"
    return write_video(path, scene_video(1, *SMALL), 30)


@pytest.fixture(scope="module")
def frames(video):
    return jvu.get_frames(video, 1)


def _equal_lists(got, ref):
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        if r is None:
            assert g is None
        else:
            assert g.dtype == r.dtype
            np.testing.assert_array_equal(g, r)


@pytest.mark.parametrize("always", [False, True])
@pytest.mark.parametrize("hw,side", [((200, 400), 100), ((96, 160), 480), ((375, 500), 333),
                                     ((97, 61), 64)])
def test_resizes_match_jax(hw, side, always):
    image = np.random.RandomState(0).randint(0, 256, hw + (3,), np.uint8)
    for port, ref in ((tvu.max_resize, jvu.max_resize), (tvu.min_resize, jvu.min_resize)):
        got, want = port(image, side, always), ref(image, side, always)
        assert (got is image) == (want is image)
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("sample_rate,max_frames", [(1, -1), (5, -1), (3, 2), (2, 512)])
def test_get_frames_matches_jax(video, sample_rate, max_frames):
    got, got_inds = tvu.get_frames(video, sample_rate, max_frames=max_frames, return_inds=True)
    ref, ref_inds = jvu.get_frames(video, sample_rate, max_frames=max_frames, return_inds=True)
    _equal_lists(got, ref)
    np.testing.assert_array_equal(got_inds, ref_inds)
    if max_frames > 0:  # the headroom: at most four times max_frames
        assert len(got) == min(4 * max_frames, -(-40 // sample_rate))
    _equal_lists(tvu.get_frames(video, sample_rate, max_frames=max_frames),
                 jvu.get_frames(video, sample_rate, max_frames=max_frames))


def test_get_frames_removes_the_video_and_reads_none_from_nothing(video, tmp_path):
    copy = shutil.copy(video, tmp_path / "copy.avi")
    _equal_lists(tvu.get_frames(copy, 4, remove_video=True), jvu.get_frames(video, 4))
    assert not os.path.exists(copy)
    empty = tmp_path / "empty.avi"
    empty.write_bytes(b"")
    assert tvu.get_frames(str(empty)) is None and jvu.get_frames(str(empty)) is None
    assert tvu.get_frames(str(empty), return_inds=True) == (None, None)


def test_get_frames_by_time_matches_jax(video):
    times = [0.0, 0.1, 0.5, 1.0, 1.3, 5.0]  # the last is past the video's end
    got = tvu.get_frames_by_time(video, times)
    _equal_lists(got, jvu.get_frames_by_time(video, times))
    assert got[-1] is None and got[0] is not None


def test_filter_similar_frames_matches_jax(frames):
    seq = frames[:10] + [frames[9]] * 3 + frames[10:]
    got, got_keep = tvu.filter_similar_frames(seq, return_inds=True)
    ref, ref_keep = jvu.filter_similar_frames(seq, return_inds=True)
    np.testing.assert_array_equal(got_keep, ref_keep)
    _equal_lists(got, ref)
    assert 0 < len(got_keep) < len(seq)
    _equal_lists(tvu.filter_similar_frames(seq, threshold=3.0),
                 jvu.filter_similar_frames(seq, threshold=3.0))


def test_filter_using_laplacian_matches_jax(frames):
    import cv2

    # every third frame blurred at sigma 2: below the threshold of 100
    seq = np.stack([cv2.GaussianBlur(f, (0, 0), 2.0) if i % 3 == 0 else f
                    for i, f in enumerate(frames)])
    got, got_keep = tvu.filter_using_laplacian(seq, return_inds=True)
    ref, ref_keep = jvu.filter_using_laplacian(seq, return_inds=True)
    np.testing.assert_array_equal(got_keep, ref_keep)
    assert got_keep.dtype == ref_keep.dtype
    np.testing.assert_array_equal(got, ref)
    assert 0 < len(got_keep) < len(seq)
    none, none_keep = tvu.filter_using_laplacian(seq, threshold=1e9, return_inds=True)
    ref_none = jvu.filter_using_laplacian(seq, threshold=1e9)
    assert none.shape == ref_none.shape == (0,) + seq.shape[1:] and len(none_keep) == 0


def test_filter_using_flow_matches_jax(frames):
    seq = np.stack(frames)
    prev = seq[:-1].copy()
    prev[::4] = seq[1::4]  # every fourth frame against itself: static, dropped
    got, got_masks, got_keep = tvu.filter_using_flow(prev, seq[1:], return_inds=True)
    ref, ref_masks, ref_keep = jvu.filter_using_flow(prev, seq[1:], return_inds=True)
    np.testing.assert_array_equal(got_keep, ref_keep)
    np.testing.assert_array_equal(got, ref)
    assert got_masks.dtype == ref_masks.dtype
    np.testing.assert_array_equal(got_masks, ref_masks)
    assert 0 < len(got_keep) < len(prev)
    got, got_masks = tvu.filter_using_flow(prev, seq[1:], min_flow=1e9)
    ref, ref_masks = jvu.filter_using_flow(prev, seq[1:], min_flow=1e9)
    assert got.shape == ref.shape and got_masks.shape == ref_masks.shape == (0, 128, 128)


@pytest.mark.parametrize("threshold", [16, 60])
def test_remove_border_matches_jax(frames, threshold):
    got, got_box = tvu.remove_border(frames, threshold, return_inds=True)
    ref, ref_box = jvu.remove_border(frames, threshold, return_inds=True)
    assert got_box == ref_box
    _equal_lists(got, ref)
    if threshold == 16:  # the black bands of 8 rows go
        assert got_box[2] > 0 and got_box[3] < 96 and got[0].shape[0] < 96
    dark = [np.zeros_like(f) for f in frames[:3]]
    assert tvu.remove_border(dark, return_inds=True)[1] == (0, 0, 0, 0)


def test_get_shots_matches_jax(frames):
    seq = np.stack(frames)
    got, got_borders = tvu.get_shots(seq, return_inds=True)
    ref, ref_borders = jvu.get_shots(seq, return_inds=True)
    assert got_borders == ref_borders
    _equal_lists(got, ref)
    assert len(got_borders) > 2  # the video's cuts
    _equal_lists(tvu.get_shots(seq, threshold=90.0), jvu.get_shots(seq, threshold=90.0))


@pytest.mark.parametrize("name", INFO_FILES)
def test_info_files_are_the_references(name):
    port = os.path.join(tutil.INFO_FILES_DIR, name)
    assert filecmp.cmp(port, os.path.join(jutil.INFO_FILES_DIR, name), shallow=False)


@pytest.mark.parametrize("table", ["imagenet_label_to_class", "sun_scene_label_to_class",
                                   "kinetics_400_label_to_class", "yt8m_label_to_class"])
def test_label_tables_match_jax(table):
    names = {"imagenet_label_to_class": "imagenet_classes.txt",
             "sun_scene_label_to_class": "sun_scene_classes.txt",
             "kinetics_400_label_to_class": "kinetics_400_classes.txt",
             "yt8m_label_to_class": "yt8m_classes.txt"}[table]
    rows = len(jutil._load_class_names(names))
    for label in range(rows):
        assert getattr(tutil, table)(label) == getattr(jutil, table)(label)


def test_imagenet_categories_match_jax():
    got = tutil.load_imagenet_categories()
    assert got == jutil.load_imagenet_categories()
    assert len(got) == 76003 and got[0] == ("n00001740", "entity")


@pytest.mark.parametrize("shape,padding", [((4, 8, 6, 3), 0), ((2, 3, 5, 7, 3), 2),
                                           ((9, 11, 3), 1)])
def test_to_uint8_matches_jax(shape, padding):
    images = np.random.RandomState(3).randn(*shape).astype(np.float32) * 1.5
    got = tutil.to_uint8(images, padding)
    ref = jutil.to_uint8(images, padding)
    assert got.dtype == ref.dtype == np.uint8
    np.testing.assert_array_equal(got, ref)


def test_video_url_matches_jax():
    assert tyt.get_video_url("AA2pFq9pFTA") == jyt.get_video_url("AA2pFq9pFTA")


def test_without_a_downloader_nothing_runs(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("no process may start")

    monkeypatch.setattr(subprocess, "run", refuse)
    assert tyt._downloader() is None
    assert tyt.download_video("AA2pFq9pFTA") is None and jyt.download_video("AA2pFq9pFTA") is None
    assert tyt.search_youtube("cat") == [] == jyt.search_youtube("cat")


class _Runs:
    """``subprocess.run`` stand-in: records each command; writes the file a
    download names, or prints ids for a search, or fails as told."""

    def __init__(self, fail=None, ext="mp4"):
        self.cmds, self.fail, self.ext = [], fail, ext

    def __call__(self, cmd, **kwargs):
        self.cmds.append((list(cmd), {k: v for k, v in kwargs.items()
                                      if k not in ("stdout", "stderr")}))
        if self.fail is not None:
            raise self.fail
        if "-o" in cmd:
            out = cmd[cmd.index("-o") + 1].replace("%(ext)s", self.ext)
            with open(out, "wb") as f:
                f.write(b"video")
            return subprocess.CompletedProcess(cmd, 0)
        return subprocess.CompletedProcess(cmd, 0, stdout="id1\n\n id2 \nid3\n")


@pytest.mark.parametrize("ext", ["mp4", "webm", "flv"])
@pytest.mark.parametrize("cookies", ["", "cookies.txt"])
def test_download_and_search_run_jax_command_lines(monkeypatch, tmp_path, ext, cookies):
    results = {}
    for label, mod in (("port", tyt), ("jax", jyt)):
        runs = _Runs(ext=ext)
        monkeypatch.setattr(mod, "_downloader", lambda: "yt-dlp")
        monkeypatch.setattr(subprocess, "run", runs)
        path = mod.download_video("vid", str(tmp_path / label), cookie_path=cookies,
                                  max_height=240)
        ids = mod.search_youtube("red fox", max_results=7)
        ids_all = mod.search_youtube("red fox", cc_only=False, max_minutes=0)
        results[label] = (path, ids, ids_all, runs.cmds)
    port, ref = results["port"], results["jax"]
    assert port[1] == ref[1] == ["id1", "id2", "id3"] and port[2] == ref[2]
    if ext == "flv":  # a container the tools do not look for
        assert port[0] is None and ref[0] is None
    else:
        assert port[0] == str(tmp_path / "port" / f"vid.{ext}")
        assert ref[0] == str(tmp_path / "jax" / f"vid.{ext}")
    assert port[3] == [([a.replace(str(tmp_path / "jax"), str(tmp_path / "port")) for a in cmd],
                        kw) for cmd, kw in ref[3]]
    assert port[3][0][1]["timeout"] == 300 and port[3][1][1]["timeout"] == 600


@pytest.mark.parametrize("error", [subprocess.CalledProcessError(1, "yt-dlp"),
                                   subprocess.TimeoutExpired("yt-dlp", 300)],
                         ids=["failed", "timed out"])
def test_a_failed_tool_gives_none_and_no_ids(monkeypatch, tmp_path, error):
    for mod in (tyt, jyt):
        monkeypatch.setattr(mod, "_downloader", lambda: "youtube-dl")
        monkeypatch.setattr(subprocess, "run", _Runs(fail=error))
        assert mod.download_video("vid", str(tmp_path)) is None
        assert mod.search_youtube("q") == []


def test_default_download_directory_is_the_temporary_one(monkeypatch, tmp_path):
    import tempfile

    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    monkeypatch.setattr(tyt, "_downloader", lambda: "yt-dlp")
    monkeypatch.setattr(subprocess, "run", _Runs())
    assert tyt.download_video("vid") == str(tmp_path / "downloaded_videos" / "vid.mp4")
