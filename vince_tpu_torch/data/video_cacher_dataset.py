"""The video cacher (counterpart of ``vince_tpu/data/video_cacher_dataset.py``):
item ``idx`` downloads video ``video_ids[idx]``, runs the filter cascade and
writes the frames it keeps. The cascade: similar-frame dedup, a random window
of ``max_video_length`` frames, border removal, the Laplacian blur filter,
the optional flow filter, then optionally the shots; ``num_frames_to_cache``
consecutive frames of each long-enough run go out as BGR JPEGs of at most
``max_side_size`` pixels a side, ``<output>/<vid[:2]>/<vid>_%06d.jpg`` (the
layout ``R2V2Dataset`` reads). An item returns (id, code): 0 cached, 1 the
download failed, 2 the filters left too few frames (in two tries), 3 no shot
was long enough. The downloaded file is removed.

The random window and the start of each cached run are drawn from ``rng`` (a
``random.Random``; by default seeded with ``args.seed``, or unseeded where
``args`` has none), where JAX draws from the global ``random``: seeded alike
and called in the same order, the two draw the same.
"""

import os
import random
from typing import List, Optional, Tuple

import numpy as np

from vince_tpu_torch.utils import video_utils, youtube_utils


class VideoCacherDataset:
    def __init__(self, args, video_ids: List[str], output_path: str,
                 filter_similar_frames: bool = True, filter_using_laplacian: bool = True,
                 filter_using_flow: bool = False, num_frames_to_cache: int = 4,
                 rng: Optional[random.Random] = None):
        self.args = args
        self.uncached_ids = video_ids
        self.output_path = output_path
        self.filter_similar_frames = filter_similar_frames
        self.filter_using_laplacian = filter_using_laplacian
        self.filter_using_flow = filter_using_flow
        self.num_frames_to_cache = num_frames_to_cache
        self.max_video_length = getattr(args, "max_video_length", 512)
        self.rng = rng if rng is not None else random.Random(getattr(args, "seed", None))

    def __len__(self):
        return len(self.uncached_ids)

    def _filtered(self, video):
        """The cascade on ``video``'s frames: (frames [N, H, W, 3], their
        indices), or None where too few frames are left."""
        result = video_utils.get_frames(
            video, getattr(self.args, "video_sample_rate", 5),
            max_frames=self.max_video_length, return_inds=True)
        if result is None or result[0] is None:
            return None
        frames, frame_inds = result

        prev_frames = None
        if self.filter_using_flow:
            prev_frames = [f.copy() for f in frames[:-1]]
            frames, frame_inds = frames[1:], frame_inds[1:]

        if self.filter_similar_frames:
            frames, keep = video_utils.filter_similar_frames(frames, return_inds=True)
            if len(frames) < self.num_frames_to_cache:
                return None
            frame_inds = frame_inds[keep]
            if prev_frames is not None:
                prev_frames = [prev_frames[i] for i in keep]

        if 0 < self.max_video_length < len(frames):
            start = self.rng.randint(0, len(frames) - self.max_video_length - 1)
            window = slice(start, start + self.max_video_length)
            frames, frame_inds = frames[window], frame_inds[window]
            if prev_frames is not None:
                prev_frames = prev_frames[window]

        frames, (x1, x2, y1, y2) = video_utils.remove_border(frames, return_inds=True)
        if frames[0].shape[0] == 0 or frames[0].shape[1] == 0:
            return None
        frames = np.stack(frames)
        if prev_frames is not None:
            prev_frames = np.stack([p[y1:y2, x1:x2] for p in prev_frames])

        if self.filter_using_laplacian:
            frames, keep = video_utils.filter_using_laplacian(frames, return_inds=True)
            if len(frames) < self.num_frames_to_cache:
                return None
            frame_inds = frame_inds[keep]
            if prev_frames is not None:
                prev_frames = prev_frames[keep]

        if self.filter_using_flow:
            frames, _, keep = video_utils.filter_using_flow(prev_frames, frames,
                                                            return_inds=True)
            if len(frames) < self.num_frames_to_cache:
                return None
            frame_inds = frame_inds[keep]
        return frames, frame_inds

    def __getitem__(self, idx) -> Tuple[str, int]:
        video_id = self.uncached_ids[idx]
        video = youtube_utils.download_video(video_id)
        if video is None:
            return video_id, 1
        kept = None
        for _ in range(2):  # the cascade's second try
            kept = self._filtered(video)
            if kept is not None:
                break
        try:
            os.remove(video)
        except OSError:
            pass
        if kept is None:
            return video_id, 2
        frames, frame_inds = kept

        if getattr(self.args, "only_use_shots", False):
            shots, borders = video_utils.get_shots(frames, return_inds=True)
            shot_ids = [frame_inds[borders[i]: borders[i + 1]] for i in range(len(borders) - 1)]
        else:
            shots, shot_ids = [frames], [frame_inds]

        long_enough = [i for i, s in enumerate(shots) if len(s) >= self.num_frames_to_cache]
        if not long_enough:
            return video_id, 3
        n = self.num_frames_to_cache
        for i in long_enough:
            start = self.rng.randint(0, len(shots[i]) - n)
            self.cache_images(shots[i][start: start + n], video_id, shot_ids[i][start: start + n],
                              max_side_size=getattr(self.args, "max_side_size", 480))
        return video_id, 0

    def cache_images(self, frames, vid_id, frame_inds, max_side_size: int = 480):
        """RGB ``frames`` as BGR JPEGs ``<vid_id>_%06d.jpg`` of their indices in
        the shard directory ``vid_id[:2]``, the longer side at most
        ``max_side_size`` (no limit at 0)."""
        import cv2

        im_dir = os.path.join(self.output_path, vid_id[:2])
        os.makedirs(im_dir, exist_ok=True)
        for image, image_id in zip(frames, frame_inds):
            if image.ndim != 3:
                continue
            if max_side_size > 0:
                image = video_utils.max_resize(image, max_side_size)
            cv2.imwrite(os.path.join(im_dir, f"{vid_id}_{int(image_id):06d}.jpg"),
                        np.asarray(image)[:, :, ::-1])
