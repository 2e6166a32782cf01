"""The ``files`` traffic: a tree of JPEG videos in the R2V2 layout
(``<split>/<id[:2]>/<id>_<frame:06d>.jpg``), written from the seed at set-up
under the run's temporary directory, which the training command's solver
reads through its loader; and the benchmark's own reading of the tree, which
the frames that reached the step are held to.

A video's frames are one smooth random scene (a coarse noise field blown up
with cv2's cubic resize), panned a few pixels a frame, with a little noise:
JPEGs of a few tens of kB, as camera frames are, where uniform noise would
take ten times the disk. Videos are written and read back by a pool of
spawned processes.
"""

import hashlib
import multiprocessing
from pathlib import Path
from typing import Dict, List, Tuple

import numpy as np

from vince_bench.traffic import derive

PAN = 4  # pixels a frame


def video_id(seed: int, index: int) -> str:
    return hashlib.blake2b(f"{seed}:{index}".encode(), digest_size=8).hexdigest()[:11]


def _frames(seed: int, index: int, count: int, width: int, height: int) -> List[np.ndarray]:
    import cv2

    rng = np.random.RandomState(derive(seed, f"video {index}") % 2 ** 32)
    coarse = rng.randint(0, 256, (height // 24 + 2, (width + PAN * count) // 24 + 2, 3))
    scene = cv2.resize(coarse.astype(np.uint8), ((coarse.shape[1] - 1) * 24,
                                                 (coarse.shape[0] - 1) * 24),
                       interpolation=cv2.INTER_CUBIC)
    out = []
    for i in range(count):
        frame = scene[:height, PAN * i:PAN * i + width].astype(np.int16)
        frame += rng.randint(-4, 5, frame.shape).astype(np.int16)
        out.append(np.clip(frame, 0, 255).astype(np.uint8))
    return out


def _write(job: Tuple[str, int, int, int, int, int, int]) -> int:
    import cv2

    split_dir, seed, first, last, count, width, height = job
    for index in range(first, last):
        vid = video_id(seed, index)
        folder = Path(split_dir) / vid[:2]
        folder.mkdir(parents=True, exist_ok=True)
        for i, rgb in enumerate(_frames(seed, index, count, width, height)):
            cv2.imwrite(str(folder / f"{vid}_{i:06d}.jpg"), rgb[:, :, ::-1],
                        [cv2.IMWRITE_JPEG_QUALITY, 90])
    return last - first


def _pool(workers: int):
    return multiprocessing.get_context("spawn").Pool(workers)


def write_tree(root: Path, traffic: dict, seed: int) -> Path:
    """The train and val splits under ``root``; returns ``root``."""
    jobs = []
    for split, videos, offset in (("train", traffic["videos"], 0),
                                  ("val", traffic["val_videos"], traffic["videos"])):
        step = max(1, videos // (4 * traffic["writers"]))
        jobs += [(str(root / split), seed, offset + a, offset + min(a + step, videos),
                  traffic["frames"], traffic["width"], traffic["height"])
                 for a in range(0, videos, step)]
    with _pool(traffic["writers"]) as pool:
        written = sum(pool.map(_write, jobs))
    if written != traffic["videos"] + traffic["val_videos"]:
        raise RuntimeError(f"wrote {written} videos")
    return root


def _read(job: Tuple[List[str], int]) -> List[Tuple[str, str]]:
    import cv2

    paths, canvas = job
    out = []
    for p in paths:
        img = cv2.cvtColor(cv2.imread(p, cv2.IMREAD_COLOR), cv2.COLOR_BGR2RGB)
        img = cv2.resize(img, (canvas, canvas), interpolation=cv2.INTER_LINEAR)
        out.append((digest(img), Path(p).name.rsplit("_", 1)[0]))
    return out


def digest(frame: np.ndarray) -> str:
    return hashlib.blake2b(np.ascontiguousarray(frame).tobytes(), digest_size=16).hexdigest()


def read_tree(split_dir: Path, canvas: int, workers: int) -> Dict[str, str]:
    """The benchmark's own reading of a split: each frame decoded by cv2,
    turned to RGB and resized to the canvas, by the digest of its pixels →
    its video."""
    paths = sorted(str(p) for p in Path(split_dir).glob("*/*.jpg"))
    chunks = [(paths[a:a + 256], canvas) for a in range(0, len(paths), 256)]
    with _pool(workers) as pool:
        return dict(pair for chunk in pool.map(_read, chunks) for pair in chunk)


def frames_not_read(batches, known: Dict[str, str], num_frames: int) -> int:
    """Rows of the recorded batches that are no frame of the tree as the
    benchmark reads it, or not of the video of their item (an item is
    ``num_frames`` query rows and as many key rows of one video)."""
    bad = 0
    for batch in batches:
        src = batch[0]
        data, keys = src["data"].cpu().numpy(), src["queue_data"].cpu().numpy()
        for item in range(0, len(data), num_frames):
            rows = list(data[item:item + num_frames]) + list(keys[item:item + num_frames])
            videos = [known.get(digest(r)) for r in rows]
            first = next((v for v in videos if v is not None), None)
            bad += sum(v is None or v != first for v in videos)
    return bad
