"""SiamFC pair crops on the host (counterpart of
``vince_tpu/tracking/siamfc_transforms.py``): the box-space composition
RandomStretchBox → CenterCropBox(instance − 8) → RandomCropBox →
[CenterCropBox(exemplar)] applied as one warp per image, and the L1-ball
binary response label of width ``positive_label_width``.

The JAX module draws from numpy's global generator; this one draws from
``rng``, an explicit ``np.random.RandomState``, in the same order, so that
``RandomState(s)`` here gives what ``np.random.seed(s)`` gives there.
"""

import copy
import numbers
from typing import Optional

import numpy as np

from vince_tpu_torch.tracking.ops import get_cropped_input, xywh_to_xyxy

__all__ = ["SiamFCTransforms"]


def _random_stretch_box(rng, box, max_stretch=0.05):
    scale = 1.0 + rng.uniform(-max_stretch, max_stretch)
    box[4] *= scale
    box[5] *= scale
    return box


def _center_crop_box(box, size):
    if isinstance(size, numbers.Number):
        size = (int(size), int(size))
    box[2] = size[1] * box[2] / box[4]
    box[3] = size[0] * box[3] / box[5]
    box[4] = size[1]
    box[5] = size[0]
    return box


def _random_crop_box(rng, box, size):
    if isinstance(size, numbers.Number):
        size = (size, size)
    box[:2] += np.clip(rng.laplace(0, 1.0 / 4, 2), -1, 1) * (box[2:4] * np.asarray(size[:2]))
    return box


class SiamFCTransforms:
    def __init__(self, exemplar_sz: int = 127, instance_sz: int = 255, context: float = 0.5,
                 label_size: Optional[int] = None,
                 positive_label_width: Optional[float] = None,
                 rng: Optional[np.random.RandomState] = None):
        self.exemplar_sz = exemplar_sz
        self.instance_sz = instance_sz
        self.context = context
        self.label_size = label_size
        self.make_label = label_size is not None
        self.rng = rng if rng is not None else np.random.RandomState()
        if self.make_label:
            half = label_size // 2
            self.y_grid, self.x_grid = np.ogrid[-half: half + 1, -half: half + 1]
            self.positive_label_width = positive_label_width

    def __call__(self, inputs):
        """(exemplar image, search image, exemplar box, search box), boxes
        1-indexed [x, y, w, h] → (exemplar crop, search crop) or, with a
        label size, (exemplar crop, (search crop, label))."""
        z, x, box_z, box_x = inputs
        z_out = self._crop_and_stretch(z, box_z, is_exemplar=True, make_label=False)
        x_out = self._crop_and_stretch(x, box_x, is_exemplar=False, make_label=self.make_label)
        return z_out, x_out

    def _box_transforms(self, box, is_exemplar):
        box = _random_stretch_box(self.rng, box)
        box = _center_crop_box(box, self.instance_sz - 8)
        if is_exemplar:
            box = _random_crop_box(self.rng, box, 0.05)
            box = _center_crop_box(box, self.exemplar_sz)
        else:
            box = _random_crop_box(self.rng, box, 0.33)
        return box

    def _crop_and_stretch(self, img, box, is_exemplar, make_label):
        box = self._get_crop_box(box, self.instance_sz)
        box_start = copy.deepcopy(box)
        box = self._box_transforms(box, is_exemplar)
        box[2:4] = np.maximum(box[2:4], 2)
        xyxy = xywh_to_xyxy(box[:4] - np.array([box[2] / 2, box[3] / 2, 0, 0]))
        avg_color = np.mean(img, axis=(0, 1), dtype=float)
        crop, _ = get_cropped_input(img, xyxy, 1.0, int(box[4]), avg_color)
        if make_label:
            # L1-ball positives around the shifted centre
            center_diff = (box_start[:2] - box[:2]) / box[3] * self.label_size
            dist = np.abs(self.x_grid - center_diff[0]) + np.abs(self.y_grid - center_diff[1])
            mask = (dist <= (self.positive_label_width / 2)).astype(np.float32)
            return crop, mask
        return crop

    def _get_crop_box(self, box, out_size):
        """1-indexed [x, y, w, h] → the centred context-padded square
        [cx, cy, w, h, out_w, out_h]."""
        box = np.array([box[1] - 1 + (box[3] - 1) / 2, box[0] - 1 + (box[2] - 1) / 2,
                        box[3], box[2]], dtype=np.float32)
        center, target_sz = box[:2], box[2:]
        context = self.context * np.sum(target_sz)
        size = np.sqrt(np.prod(target_sz + context))
        size *= out_size / self.exemplar_sz
        return np.array([center[1], center[0], size, size, out_size, out_size], np.float64)
