"""Frame reads and the filter cascade of the video cacher (counterpart of
``vince_tpu/utils/video_utils.py``): ``get_frames`` and ``get_frames_by_time``
decode with ``cv2``; ``filter_similar_frames`` drops near-duplicates on 64²
gray thumbnails, ``filter_using_laplacian`` blurry frames, ``filter_using_flow``
static or jumping ones (Farneback on 128² thumbnails), ``remove_border``
letterbox bands (256² thumbnails), ``get_shots`` cuts by colour histogram;
``max_resize``/``min_resize`` scale a side to a size. All of it runs on the
host. ``cv2`` is imported where it is called, so the module imports without it.
"""

import os
from typing import List, Optional, Sequence

import numpy as np


def _scaled(image: np.ndarray, scale: float) -> np.ndarray:
    import cv2

    h, w = image.shape[:2]
    return cv2.resize(image, (int(round(w * scale)), int(round(h * scale))))


def max_resize(image: np.ndarray, max_side: int, always_resize: bool = False) -> np.ndarray:
    """``image`` scaled so that its longer side is ``max_side``; unchanged
    (the same object) where it is no longer, unless ``always_resize``."""
    h, w = image.shape[:2]
    if max(h, w) <= max_side and not always_resize:
        return image
    return _scaled(image, max_side / max(h, w))


def min_resize(image: np.ndarray, min_side: int, always_resize: bool = False) -> np.ndarray:
    """``image`` scaled so that its shorter side is ``min_side``; unchanged
    where it is no shorter, unless ``always_resize``."""
    h, w = image.shape[:2]
    if min(h, w) >= min_side and not always_resize:
        return image
    return _scaled(image, min_side / min(h, w))


def get_frames(video_path: str, sample_rate: int = 5, max_frames: int = -1,
               remove_video: bool = False, return_inds: bool = False,
               fps: Optional[float] = None):
    """Every ``sample_rate``-th frame of the video (RGB), and its index with
    ``return_inds``. With ``max_frames`` > 0 the read stops at ``4 *
    max_frames`` frames: headroom for the filters that follow. None (or
    (None, None)) for a video without frames. ``fps`` is unused, as in JAX."""
    import cv2

    cap = cv2.VideoCapture(video_path)
    frames, inds = [], []
    idx = 0
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        if idx % max(sample_rate, 1) == 0:
            frames.append(cv2.cvtColor(frame, cv2.COLOR_BGR2RGB))
            inds.append(idx)
            if 0 < max_frames * 4 <= len(frames):
                break
        idx += 1
    cap.release()
    if remove_video:
        os.remove(video_path)
    if not frames:
        return (None, None) if return_inds else None
    if return_inds:
        return frames, np.asarray(inds)
    return frames


def get_frames_by_time(video_path: str, times_s: Sequence[float]):
    """The frame at each time (seconds), by a seek and a read: RGB, or None
    where the read fails."""
    import cv2

    cap = cv2.VideoCapture(video_path)
    out = []
    for t in times_s:
        cap.set(cv2.CAP_PROP_POS_MSEC, t * 1000.0)
        ok, frame = cap.read()
        out.append(cv2.cvtColor(frame, cv2.COLOR_BGR2RGB) if ok else None)
    cap.release()
    return out


def _gray_small(frame: np.ndarray, size: int = 64) -> np.ndarray:
    import cv2

    g = cv2.cvtColor(frame, cv2.COLOR_RGB2GRAY)
    return cv2.resize(g, (size, size)).astype(np.float32)


def filter_similar_frames(frames: List[np.ndarray], threshold: float = 10.0,
                          return_inds: bool = False):
    """The frames whose 64² gray thumbnail differs from the last kept one's by
    a mean absolute difference of ``threshold`` or more (the first is kept)."""
    keep = [0]
    last = _gray_small(frames[0])
    for i in range(1, len(frames)):
        g = _gray_small(frames[i])
        if np.mean(np.abs(g - last)) >= threshold:
            keep.append(i)
            last = g
    kept = [frames[i] for i in keep]
    if return_inds:
        return kept, np.asarray(keep)
    return kept


def _kept(frames, keep) -> np.ndarray:
    frames = np.asarray(frames)
    return frames[keep] if len(keep) else np.zeros((0,) + frames.shape[1:], np.uint8)


def filter_using_laplacian(frames: np.ndarray, threshold: float = 100.0,
                           return_inds: bool = False):
    """The frames whose gray Laplacian has a variance of ``threshold`` or more
    (the sharp ones)."""
    import cv2

    keep = [i for i, frame in enumerate(frames)
            if cv2.Laplacian(cv2.cvtColor(np.asarray(frame), cv2.COLOR_RGB2GRAY),
                             cv2.CV_32F).var() >= threshold]
    kept = _kept(frames, keep)
    if return_inds:
        return kept, np.asarray(keep, np.int64)
    return kept


def filter_using_flow(prev_frames: np.ndarray, frames: np.ndarray, min_flow: float = 0.5,
                      max_flow: float = 50.0, return_inds: bool = False):
    """The frames whose mean Farneback flow from their previous frame (128²
    gray thumbnails) lies in [min_flow, max_flow], and for each the mask of
    the pixels that move more than the mean."""
    import cv2

    keep, masks = [], []
    for i in range(len(frames)):
        a = _gray_small(np.asarray(prev_frames[i]), 128)
        b = _gray_small(np.asarray(frames[i]), 128)
        flow = cv2.calcOpticalFlowFarneback(a, b, None, 0.5, 3, 15, 3, 5, 1.2, 0)
        mag = np.linalg.norm(flow, axis=-1)
        if min_flow <= float(mag.mean()) <= max_flow:
            keep.append(i)
            masks.append(mag > mag.mean())
    kept = _kept(frames, keep)
    masks = np.asarray(masks) if masks else np.zeros((0, 128, 128), bool)
    if return_inds:
        return kept, masks, np.asarray(keep, np.int64)
    return kept, masks


def remove_border(frames: List[np.ndarray], threshold: int = 16, return_inds: bool = False):
    """The frames cropped to the rows and columns where any frame's 256² gray
    thumbnail has mean + std above ``threshold`` (letterbox bands go), and
    with ``return_inds`` the box (x1, x2, y1, y2)."""
    stack = np.stack([_gray_small(np.asarray(f), 256) for f in frames])
    energy = stack.std(axis=0) + stack.mean(axis=0)
    col_live = np.where(energy.max(axis=0) > threshold)[0]
    row_live = np.where(energy.max(axis=1) > threshold)[0]
    h, w = np.asarray(frames[0]).shape[:2]
    if len(col_live) == 0 or len(row_live) == 0:
        x1 = x2 = y1 = y2 = 0
    else:
        x1 = int(col_live[0] / 256 * w)
        x2 = int((col_live[-1] + 1) / 256 * w)
        y1 = int(row_live[0] / 256 * h)
        y2 = int((row_live[-1] + 1) / 256 * h)
    cropped = [np.asarray(f)[y1:y2, x1:x2] for f in frames]
    if return_inds:
        return cropped, (x1, x2, y1, y2)
    return cropped


def get_shots(frames: np.ndarray, threshold: float = 40.0, return_inds: bool = False):
    """The runs of frames between cuts: a cut where the 8x8x8 colour
    histograms of two neighbours differ by more than ``threshold`` percent
    (L1). With ``return_inds`` also the borders [0, ..., len(frames)]."""
    import cv2

    borders = [0]
    prev_hist = None
    for i, frame in enumerate(frames):
        hist = cv2.calcHist([np.asarray(frame)], [0, 1, 2], None, [8, 8, 8],
                            [0, 256] * 3).flatten()
        hist = hist / max(hist.sum(), 1)
        if prev_hist is not None and np.abs(hist - prev_hist).sum() * 100 > threshold:
            borders.append(i)
        prev_hist = hist
    borders.append(len(frames))
    shots = [np.asarray(frames)[borders[i]: borders[i + 1]] for i in range(len(borders) - 1)]
    if return_inds:
        return shots, borders
    return shots
