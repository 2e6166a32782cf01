"""Procedural datasets (counterpart of ``vince_tpu/data/synthetic_dataset.py``):
videos and images made from a seed, so that a run, a test or a benchmark
needs no data on disk. Items are bit-equal to the JAX package's for the same
arguments and index.

``SyntheticTextureVideoDataset`` and the other texture families are numpy
alone; ``SyntheticVideoDataset``'s scenes are drawn with ``cv2``, imported
where a scene is made.
"""

from typing import Dict, Optional

import numpy as np

from vince_tpu_torch.data.base_dataset import BaseDataset


def _equalized_grating(y0: int, y1: int, x0: int, x1: int, size: int,
                       theta: float, freq: float, phase: float) -> np.ndarray:
    """Oriented sinusoidal grating over cell [y0:y1, x0:x1], histogram-
    equalized: ranks mapped onto a fixed uniform ramp so the cell's intensity
    MULTISET is identical for every (theta, freq, phase) — zero
    color-statistic identity leak (see SyntheticTextureVideoDataset)."""
    yy, xx = np.mgrid[y0:y1, x0:x1].astype(np.float32) / float(size)
    wave = np.sin(
        2 * np.pi * freq * (xx * np.cos(theta) + yy * np.sin(theta)) + phase
    )
    flat = wave.ravel()
    ranks = np.empty_like(flat)
    ranks[np.argsort(flat, kind="stable")] = (
        (np.arange(flat.size) + 0.5) / flat.size
    )
    return ranks.reshape(wave.shape)


def _texture_scene(rng: np.random.RandomState, size: int, grid: int,
                   n_angles: int, freqs, c1: np.ndarray,
                   c2: np.ndarray) -> np.ndarray:
    """GRID×GRID equalized-grating canvas through one duotone palette (the
    non-color-separable family's renderer; draw order is pinned — existing
    identity codes depend on it)."""
    bounds = [size * g // grid for g in range(grid + 1)]
    canvas = np.empty((size, size, 3), np.float32)
    for gy in range(grid):
        for gx in range(grid):
            y0, y1 = bounds[gy], bounds[gy + 1]
            x0, x1 = bounds[gx], bounds[gx + 1]
            theta = np.pi * rng.randint(0, n_angles) / n_angles
            freq = freqs[rng.randint(0, len(freqs))]
            phase = rng.uniform(0, 2 * np.pi)
            inten = _equalized_grating(y0, y1, x0, x1, size, theta, freq,
                                       phase)[..., None]
            canvas[y0:y1, x0:x1] = inten * c1 + (1.0 - inten) * c2
    return np.clip(canvas, 0, 255).astype(np.uint8)


def _video_canvas(rng: np.random.RandomState, size: int) -> np.ndarray:
    """A synthetic 'scene': random low-frequency color field + shapes."""
    base = rng.randint(0, 256, (4, 4, 3), np.uint8)
    import cv2

    canvas = cv2.resize(base, (size, size), interpolation=cv2.INTER_CUBIC)
    for _ in range(3):
        center = tuple(rng.randint(0, size, 2).tolist())
        radius = int(rng.randint(size // 8, size // 3))
        color = tuple(int(c) for c in rng.randint(0, 256, 3))
        cv2.circle(canvas, center, radius, color, -1)
    return canvas


class SyntheticVideoDataset(BaseDataset):
    """R2V2-shaped items: ``num_frames`` query/key frame pairs per video."""

    def __init__(self, args, data_subset: str = "train", num_videos: int = 512,
                 num_images_to_return: int = -1, seed: int = 0):
        super().__init__(args, data_subset)
        self.num_images_to_return = (
            num_images_to_return if num_images_to_return > 0 else args.num_frames
        )
        self.num_videos = num_videos
        self.seed = seed + (0 if data_subset == "train" else 10_000_000)

    def __len__(self):
        return self.num_videos

    def _frame(self, scene: np.ndarray, rng: np.random.RandomState) -> np.ndarray:
        """Per-frame camera jitter: small shift + brightness."""
        shift = rng.randint(-self.canvas // 16, self.canvas // 16 + 1, 2)
        frame = np.roll(scene, shift, axis=(0, 1))
        gain = rng.uniform(0.8, 1.2)
        return np.clip(frame.astype(np.float32) * gain, 0, 255).astype(np.uint8)

    def __getitem__(self, idx) -> Optional[Dict[str, np.ndarray]]:
        vid_rng = np.random.RandomState(self.seed + idx)
        scene = _video_canvas(vid_rng, self.canvas)
        if getattr(self.args, "repeatable", False):
            # per-item deterministic jitter (reference r2v2_dataset.py:57-61
            # repeatable mode) — loader threads race on the global RNG, so
            # determinism tests need draws keyed by idx, not draw order
            frame_rng = np.random.RandomState(self.seed + 7919 * (idx + 1))
        else:
            frame_rng = np.random.RandomState(np.random.randint(0, 2 ** 31))
        queries = [self._frame(scene, frame_rng) for _ in range(self.num_images_to_return)]
        keys = [self._frame(scene, frame_rng) for _ in range(self.num_images_to_return)]
        return {
            "data": np.stack(queries),
            "queue_data": np.stack(keys),
            "ind": np.int64(idx),
            "id": f"synth{idx:08d}",
        }


class SyntheticTextureVideoDataset(SyntheticVideoDataset):
    """Texture-coded videos that are NOT separable by color statistics, so
    that an encoder that learns them cannot have learned color histograms.

    Identity i is a 2×2 grid of oriented sinusoidal gratings; each cell's
    (orientation ∈ 8 angles over [0,π), frequency ∈ {3,5,8,12} cycles) is
    drawn from RandomState(seed+i) → ~1M distinguishable codes. Each cell's
    intensities are rank-transformed to the SAME fixed uniform ramp
    (histogram equalization — a monotone map that preserves the grating's
    spatial structure), then rendered through ONE global duotone palette
    shared by every video. Every cell of every video therefore has the
    IDENTICAL intensity multiset: per-video mean color and color histograms
    are equal by construction, not approximately (sinusoids over truncated
    cells leave partial-cycle residuals that leak identity — measured 0.56
    color-NN retrieval before the rank transform, ≈chance after).

    ⇒ mean-RGB and color-histogram classifiers sit at chance across
    identities (by construction), while
    translation-invariant spatial features (e.g. |FFT|) separate identities
    perfectly. A contrastive encoder that learns this family above chance
    must have learned spatial structure, not color. Same item contract and
    per-frame jitter (roll + gain) as SyntheticVideoDataset.
    """

    N_ANGLES = 8
    FREQS = (3.0, 5.0, 8.0, 12.0)
    GRID = 2
    # one palette for the entire dataset — color carries zero identity bits
    C1 = np.array([210, 120, 40], np.float32)
    C2 = np.array([30, 90, 180], np.float32)

    def _scene(self, idx: int) -> np.ndarray:
        # exact tiling (the bounds in _texture_scene): cell (gy,gx) has the
        # same size for EVERY video, so per-cell equalized multisets — and
        # hence the scene's color statistics — are bit-identical across
        # identities (a ceil-sized grid + crop truncates pattern-dependent
        # pixels and leaks ~2/255 of identity into the histogram; measured)
        return _texture_scene(
            np.random.RandomState(self.seed + idx), self.canvas, self.GRID,
            self.N_ANGLES, self.FREQS, self.C1, self.C2,
        )

    def __getitem__(self, idx) -> Optional[Dict[str, np.ndarray]]:
        scene = self._scene(idx)
        if getattr(self.args, "repeatable", False):
            frame_rng = np.random.RandomState(self.seed + 7919 * (idx + 1))
        else:
            frame_rng = np.random.RandomState(np.random.randint(0, 2 ** 31))
        queries = [self._frame(scene, frame_rng) for _ in range(self.num_images_to_return)]
        keys = [self._frame(scene, frame_rng) for _ in range(self.num_images_to_return)]
        return {
            "data": np.stack(queries),
            "queue_data": np.stack(keys),
            "ind": np.int64(idx),
            "id": f"tex{idx:08d}",
        }


class SyntheticClipDataset(BaseDataset):
    """Kinetics-shaped labeled clips: [T] frames sharing a class-colored scene."""

    def __init__(self, args, data_subset: str = "train", num_clips: int = 256,
                 num_classes: int = 0, num_images_to_return: int = -1, seed: int = 0):
        super().__init__(args, data_subset)
        num_classes = num_classes or getattr(args, "end_task_classifier_num_classes", 0) or 4
        self.num_clips = num_clips
        self.num_classes = num_classes
        self.num_frames = (
            num_images_to_return if num_images_to_return > 0 else max(args.num_frames, 1)
        )
        self.seed = seed + (0 if data_subset == "train" else 10_000_000)
        rng = np.random.RandomState(321)
        self.class_colors = rng.randint(0, 256, (num_classes, 3), np.uint8)

    def __len__(self):
        return self.num_clips

    def __getitem__(self, idx):
        rng = np.random.RandomState(self.seed + idx)
        label = int(idx % self.num_classes)
        base = np.ones((self.canvas, self.canvas, 3), np.uint8) * self.class_colors[label]
        frames = []
        for _ in range(self.num_frames):
            noise = rng.randint(-40, 41, base.shape).astype(np.int16)
            frames.append(np.clip(base.astype(np.int16) + noise, 0, 255).astype(np.uint8))
        return {
            "data": np.stack(frames),
            "labels": np.int32(label),
            "classifier_labels": np.int32(label),
            "ind": np.int64(idx),
        }


class SyntheticImageDataset(BaseDataset):
    """Labeled images where the label is recoverable from the dominant color —
    lets probe/classifier tests verify learning above chance."""

    def __init__(self, args, data_subset: str = "train", num_images: int = 512,
                 num_classes: int = 0, seed: int = 0):
        super().__init__(args, data_subset)
        num_classes = num_classes or getattr(args, "end_task_classifier_num_classes", 0) or 10
        self.num_views = max(getattr(args, "num_frames", 1), 1)
        self.num_images = num_images
        self.num_classes = num_classes
        self.seed = seed + (0 if data_subset == "train" else 10_000_000)
        rng = np.random.RandomState(123)
        self.class_colors = rng.randint(0, 256, (num_classes, 3), np.uint8)

    def __len__(self):
        return self.num_images

    def __getitem__(self, idx) -> Optional[Dict[str, np.ndarray]]:
        rng = np.random.RandomState(self.seed + idx)
        label = int(idx % self.num_classes)
        img = np.ones((self.canvas, self.canvas, 3), np.uint8) * self.class_colors[label]
        noise = rng.randint(-40, 41, img.shape).astype(np.int16)
        img = np.clip(img.astype(np.int16) + noise, 0, 255).astype(np.uint8)
        reps = np.repeat(img[None], self.num_views, axis=0)
        return {
            "data": reps,
            "queue_data": reps,
            "labels": np.repeat(np.int32(label), self.num_views),
            "imagenet_labels": np.repeat(np.int32(label), self.num_views),
            "classifier_labels": np.repeat(np.int32(label), self.num_views),
            "ind": np.int64(idx),
        }

    def as_clip_item(self, idx, num_frames):
        """Kinetics-shaped item: [T, C, C, 3] frames + class label."""
        item = self[idx]
        return {
            "data": np.repeat(item["data"], num_frames, axis=0),
            "labels": item["labels"],
            "classifier_labels": item["labels"],
            "ind": np.int64(idx),
        }

    def as_npz_arrays(self):
        data = np.stack([self[i]["data"][0] for i in range(len(self))])
        labels = np.asarray([i % self.num_classes for i in range(len(self))], np.int32)
        return data, labels


class SyntheticTextureImageDataset(BaseDataset):
    """Labeled images whose class is carried ONLY by texture.

    Class c is a fixed grating-grid identity rendered by the same
    non-color-separable generator as SyntheticTextureVideoDataset — every
    class has the bit-identical intensity multiset through one shared duotone
    palette, so mean-RGB / color-histogram classifiers sit at chance across
    classes by construction
    while oriented spatial features separate them. Item contract matches
    SyntheticImageDataset (labels/imagenet_labels/classifier_labels)."""

    def __init__(self, args, data_subset: str = "train", num_images: int = 512,
                 num_classes: int = 0, seed: int = 0):
        super().__init__(args, data_subset)
        num_classes = num_classes or getattr(args, "end_task_classifier_num_classes", 0) or 10
        self.num_views = max(getattr(args, "num_frames", 1), 1)
        self.num_images = num_images
        self.num_classes = num_classes
        self.seed = seed + (0 if data_subset == "train" else 10_000_000)
        T = SyntheticTextureVideoDataset
        self.class_scenes = [
            _texture_scene(np.random.RandomState(424_242 + c), self.canvas,
                           T.GRID, T.N_ANGLES, T.FREQS, T.C1, T.C2)
            for c in range(num_classes)
        ]

    def __len__(self):
        return self.num_images

    def _jitter(self, scene: np.ndarray, rng: np.random.RandomState) -> np.ndarray:
        shift = rng.randint(-self.canvas // 16, self.canvas // 16 + 1, 2)
        frame = np.roll(scene, shift, axis=(0, 1))
        gain = rng.uniform(0.8, 1.2)
        return np.clip(frame.astype(np.float32) * gain, 0, 255).astype(np.uint8)

    def __getitem__(self, idx) -> Optional[Dict[str, np.ndarray]]:
        rng = np.random.RandomState(self.seed + idx)
        label = int(idx % self.num_classes)
        views = np.stack([
            self._jitter(self.class_scenes[label], rng)
            for _ in range(self.num_views)
        ])
        return {
            "data": views,
            "queue_data": views,
            "labels": np.repeat(np.int32(label), self.num_views),
            "imagenet_labels": np.repeat(np.int32(label), self.num_views),
            "classifier_labels": np.repeat(np.int32(label), self.num_views),
            "ind": np.int64(idx),
        }


class SyntheticTextureClipDataset(BaseDataset):
    """Kinetics-shaped labeled clips on the non-color-separable texture
    family: [T] jittered frames of the class's grating-grid scene. The LSTM
    probe must read spatial structure — a per-frame color histogram is at
    chance across classes by construction."""

    def __init__(self, args, data_subset: str = "train", num_clips: int = 256,
                 num_classes: int = 0, num_images_to_return: int = -1, seed: int = 0):
        super().__init__(args, data_subset)
        num_classes = num_classes or getattr(args, "end_task_classifier_num_classes", 0) or 4
        self.num_clips = num_clips
        self.num_classes = num_classes
        self.num_frames = (
            num_images_to_return if num_images_to_return > 0 else max(args.num_frames, 1)
        )
        self.seed = seed + (0 if data_subset == "train" else 10_000_000)
        T = SyntheticTextureVideoDataset
        self.class_scenes = [
            _texture_scene(np.random.RandomState(424_242 + c), self.canvas,
                           T.GRID, T.N_ANGLES, T.FREQS, T.C1, T.C2)
            for c in range(num_classes)
        ]

    def __len__(self):
        return self.num_clips

    def __getitem__(self, idx):
        rng = np.random.RandomState(self.seed + idx)
        label = int(idx % self.num_classes)
        scene = self.class_scenes[label]
        frames = []
        for _ in range(self.num_frames):
            shift = rng.randint(-self.canvas // 16, self.canvas // 16 + 1, 2)
            frame = np.roll(scene, shift, axis=(0, 1))
            gain = rng.uniform(0.8, 1.2)
            frames.append(
                np.clip(frame.astype(np.float32) * gain, 0, 255).astype(np.uint8)
            )
        return {
            "data": np.stack(frames),
            "labels": np.int32(label),
            "classifier_labels": np.int32(label),
            "ind": np.int64(idx),
        }
