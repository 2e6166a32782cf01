"""Host-side tracking image ops (counterpart of ``vince_tpu/tracking/ops.py``).

The JAX package crops with one ``cv2.warpAffine`` (bilinear, constant border
at the mean colour). The crop here is a numpy replica of it, so that the
tracker and the pair datasets need ``cv2`` only to read image files. The crop's matrix only scales and translates, so the
warp is separable: each output row reads two source rows and each output
column two source columns. As cv2 does, the replica inverts the 2×3 matrix
in float64, computes the source coordinates in float32 at the integer output
pixels, interpolates with the floor's fractional weights, rounds to nearest
and gives a tap outside the image the border value, rounded to an integer.
It agrees with ``cv2.warpAffine`` to within 1 of 255 on a few pixels in 10⁵.
"""

from typing import Optional, Sequence, Tuple

import numpy as np


def _inverse_affine(m: np.ndarray) -> np.ndarray:
    """cv2's ``invertAffineTransform`` in float64."""
    m = np.asarray(m, np.float64)
    d = m[0, 0] * m[1, 1] - m[0, 1] * m[1, 0]
    d = 1.0 / d if d != 0 else 0.0
    a00, a11 = m[1, 1] * d, m[0, 0] * d
    a01, a10 = -m[0, 1] * d, -m[1, 0] * d
    return np.array([[a00, a01, -a00 * m[0, 2] - a01 * m[1, 2]],
                     [a10, a11, -a10 * m[0, 2] - a11 * m[1, 2]]])


def _taps(scale: float, offset: float, n: int):
    """Source coordinate of each of ``n`` output pixels along one axis:
    (floor index, fractional weight [n] float32)."""
    s = np.float32(scale) * np.arange(n, dtype=np.float32) + np.float32(offset)
    floor = np.floor(s)
    return floor.astype(np.int64), s - floor


def warp_scale_translate(image: np.ndarray, m: np.ndarray, out_size: int,
                         border: Sequence[float]) -> np.ndarray:
    """``cv2.warpAffine(image, m, (out_size, out_size), INTER_LINEAR,
    BORDER_CONSTANT, border)`` for a uint8 [H, W, C] image and a matrix
    without rotation or shear."""
    inv = _inverse_affine(m)
    if inv[0, 1] != 0 or inv[1, 0] != 0:
        raise ValueError("only a scale and a translation are supported")
    h, w, c = image.shape
    x0, ax = _taps(inv[0, 0], inv[0, 2], out_size)
    y0, ay = _taps(inv[1, 1], inv[1, 2], out_size)
    fill = np.round(np.asarray(border, np.float64)).astype(np.float32)
    cols = np.concatenate([x0, x0 + 1])
    cols = cols[(cols >= 0) & (cols < w)]
    if cols.size == 0:
        return np.broadcast_to(np.clip(fill, 0, 255).astype(np.uint8),
                               (out_size, out_size, c)).copy()
    c0, c1 = int(cols.min()), int(cols.max()) + 1
    band = image[:, c0:c1]  # the source columns the crop reads

    def rows(index):
        r = band[np.clip(index, 0, h - 1)].astype(np.float32)
        outside = (index < 0) | (index >= h)
        if outside.any():
            r[outside] = fill
        return r

    top = rows(y0)
    v = rows(y0 + 1)
    v -= top
    v *= ay[:, None, None]
    v += top

    def columns(index):
        index = index - c0
        p = np.take(v, np.clip(index, 0, c1 - c0 - 1), axis=1)
        outside = (index < 0) | (index >= c1 - c0)
        if outside.any():
            p[:, outside] = fill
        return p

    left = columns(x0)
    p = columns(x0 + 1)
    p -= left
    p *= ax[None, :, None]
    p += left
    np.rint(p, out=p)
    np.clip(p, 0, 255, out=p)
    return p.astype(np.uint8)


def get_cropped_input(image: np.ndarray, xyxy: Sequence[float], padding_scale: float = 1.0,
                      out_size: int = 255,
                      pad_color: Optional[Sequence[float]] = None) -> Tuple[np.ndarray, np.ndarray]:
    """Crop ``xyxy`` (scaled about its centre by ``padding_scale``) and resize
    it to (out_size, out_size) in one warp, with the mean colour (or
    ``pad_color``) outside the image. Returns (crop uint8, the 2×3 float32
    matrix from image to crop)."""
    x1, y1, x2, y2 = [float(v) for v in xyxy]
    cx, cy = (x1 + x2) / 2.0, (y1 + y2) / 2.0
    w = max((x2 - x1) * padding_scale, 1e-3)
    h = max((y2 - y1) * padding_scale, 1e-3)
    sx, sy = out_size / w, out_size / h
    # out = s * (in - center) + out_size / 2
    m = np.array([[sx, 0.0, out_size / 2.0 - cx * sx], [0.0, sy, out_size / 2.0 - cy * sy]],
                 dtype=np.float32)
    if pad_color is None:
        pad_color = image.mean(axis=(0, 1))
    return warp_scale_translate(image, m, int(out_size), np.atleast_1d(pad_color)), m


def read_image(path: str) -> Optional[np.ndarray]:
    """An image file as RGB uint8 [H, W, 3], None if it cannot be read. It
    needs ``cv2`` (the file-backed datasets read with it too, ``ROADMAP.md``
    §1 item 6); frames held in memory need no read."""
    try:
        import cv2
    except ImportError as e:
        raise RuntimeError("reading an image file needs cv2, which is not installed here; the "
                           "tracking sequences in memory need none (the file-backed "
                           "datasets read with cv2 too: ROADMAP.md §1 item 6)") from e
    img = cv2.imread(path, cv2.IMREAD_COLOR)
    if img is None:
        return None
    return cv2.cvtColor(img, cv2.COLOR_BGR2RGB)


def load_frame(frame) -> Optional[np.ndarray]:
    """A frame given as a uint8 array (returned as it is) or as a path."""
    return frame if isinstance(frame, np.ndarray) else read_image(frame)


def xywh_to_xyxy(box: np.ndarray) -> np.ndarray:
    """[x, y, w, h] → [x1, y1, x2, y2], float32."""
    box = np.asarray(box, np.float32)
    return np.array([box[0], box[1], box[0] + box[2], box[1] + box[3]], np.float32)


def iou_xyxy(a: np.ndarray, b: np.ndarray) -> float:
    ix1, iy1 = max(a[0], b[0]), max(a[1], b[1])
    ix2, iy2 = min(a[2], b[2]), min(a[3], b[3])
    inter = max(0.0, ix2 - ix1) * max(0.0, iy2 - iy1)
    area_a = max(0.0, a[2] - a[0]) * max(0.0, a[3] - a[1])
    area_b = max(0.0, b[2] - b[0]) * max(0.0, b[3] - b[1])
    return inter / max(area_a + area_b - inter, 1e-12)
