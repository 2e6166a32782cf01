"""Image grids, borders and outlined text for the image panels (counterpart
of the parts of ``vince_tpu/utils/drawing.py`` that the panels use). ``cv2``
is imported where a cell is resized or text drawn."""

from typing import Sequence, Tuple

import numpy as np


def _to_uint8_image(img: np.ndarray) -> np.ndarray:
    img = np.asarray(img)
    if img.dtype == np.uint8:
        out = img
    else:
        img = img.astype(np.float32)
        lo, hi = img.min(), img.max()
        if hi > lo:
            img = (img - lo) / (hi - lo)
        out = (img * 255).astype(np.uint8)
    if out.ndim == 2:
        out = np.tile(out[..., None], (1, 1, 3))
    if out.shape[-1] == 1:
        out = np.tile(out, (1, 1, 3))
    return out


def subplot(
    images: Sequence[np.ndarray],
    rows: int,
    cols: int,
    cell_width: int,
    cell_height: int,
    border: int = 0,
) -> np.ndarray:
    """Arrange images row-major into a (rows*cell_h, cols*cell_w) uint8 canvas,
    resizing each cell; missing cells stay black."""
    canvas = np.zeros(
        (rows * (cell_height + 2 * border), cols * (cell_width + 2 * border), 3), np.uint8
    )
    for idx, img in enumerate(images[: rows * cols]):
        r, c = idx // cols, idx % cols
        cell = _to_uint8_image(img)
        if cell.shape[:2] != (cell_height, cell_width):
            import cv2

            cell = cv2.resize(cell, (cell_width, cell_height), interpolation=cv2.INTER_LINEAR)
        y = r * (cell_height + 2 * border) + border
        x = c * (cell_width + 2 * border) + border
        canvas[y : y + cell_height, x : x + cell_width] = cell
    return canvas


def draw_contrast_text_cv2(
    image: np.ndarray,
    text: str,
    origin: Tuple[int, int],
    font_scale: float = 0.5,
) -> np.ndarray:
    """White text with a black outline (readable on any background)."""
    import cv2

    image = np.ascontiguousarray(image)
    font = cv2.FONT_HERSHEY_SIMPLEX
    cv2.putText(image, text, origin, font, font_scale, (0, 0, 0), 3, cv2.LINE_AA)
    cv2.putText(image, text, origin, font, font_scale, (255, 255, 255), 1, cv2.LINE_AA)
    return image


def draw_border(image: np.ndarray, color: Tuple[int, int, int], width: int = 10) -> np.ndarray:
    """A solid border, in place (marks positives and sources in the panels)."""
    image = np.ascontiguousarray(image)
    image[:width], image[-width:] = color, color
    image[:, :width], image[:, -width:] = color, color
    return image
