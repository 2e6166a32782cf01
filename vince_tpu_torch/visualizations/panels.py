"""Image panels for tensorboard (counterpart of
``vince_tpu/visualizations/panels.py``): input pair grids, top-9
nearest-neighbour panels with coloured borders (orange = a correct positive,
green = the ImageNet source, purple = the video source, red = the positive
missing from the top k), ImageNet prediction grids, attention overlays.
``cv2`` is imported where an image is resized or text drawn.
"""

from typing import List, Optional, Sequence

import numpy as np

from vince_tpu_torch.utils.drawing import draw_border, draw_contrast_text_cv2, subplot
from vince_tpu_torch.utils.util_functions import imagenet_label_to_class


def _resize(img: np.ndarray, w: int, h: int) -> np.ndarray:
    import cv2

    return cv2.resize(img, (w, h), interpolation=cv2.INTER_LINEAR)


ORANGE = (255, 128, 0)
PURPLE = (90, 46, 158)
GREEN = (24, 178, 24)
GRAY = (128, 128, 128)
RED = (255, 0, 0)
BLUE = (0, 0, 203)


def input_pair_grid(
    data_u8: np.ndarray, queue_data_u8: np.ndarray, num_frames: int = 1
) -> np.ndarray:
    """Query frames, then orange-bordered key frames, a row per video."""
    nf = max(num_frames, 1)
    h, w = data_u8.shape[1:3]
    data = data_u8.reshape(-1, nf, *data_u8.shape[1:])
    keys = queue_data_u8.reshape(-1, nf, *queue_data_u8.shape[1:])
    images: List[np.ndarray] = []
    for bb in range(min(len(data), max(2 * nf, int(32 / nf)))):
        images.extend(data[bb])
        for ss in range(nf):
            images.append(draw_border(keys[bb, ss].copy(), ORANGE))
    n_cols = max(2 * nf, 8)
    n_rows = max(-(-len(images) // n_cols), 1)  # ceil: keep the last row
    return subplot(images, n_rows, n_cols, w, h)


def nearest_neighbor_panel(
    data_u8: np.ndarray,  # [B, H, W, 3] query images
    queue_data_u8: np.ndarray,  # [B, H, W, 3] key images
    similarities: np.ndarray,  # [B, B + K] raw sims (batch keys then queue)
    mask: np.ndarray,  # [B, B + K] positive mask
    queue_images: Sequence[Optional[np.ndarray]],  # host ring thumbnails [K']
    queue_sources: Sequence[Optional[str]],
    temperature: float = 0.07,
    data_source: str = "YT",
    n_neighbors: int = 9,
    rng: Optional[np.random.RandomState] = None,
) -> np.ndarray:
    """Top-k neighbour rows with the border colour code above."""
    rng = rng or np.random.RandomState(0)
    b = data_u8.shape[0]
    h, w = data_u8.shape[1:3]
    softmax = np.exp(similarities / temperature - similarities.max(-1, keepdims=True))
    softmax /= softmax.sum(-1, keepdims=True)
    topk = np.argsort(-softmax, axis=1)[:, :n_neighbors]

    images: List[np.ndarray] = []
    order = rng.choice(b, min(b, n_neighbors + 1), replace=False)
    for bb in order:
        q = data_u8[bb].copy()
        draw_border(q, GREEN if data_source == "IN" else PURPLE)
        images.append(q)
        found = False
        for nn_i, neighbor in enumerate(topk[bb]):
            color = GRAY
            if neighbor < b:
                img = queue_data_u8[neighbor].copy()
                src = data_source
            else:
                qi = (neighbor - b) % max(len(queue_images), 1)
                stored = queue_images[qi] if queue_images else None
                img = (
                    _resize(np.asarray(stored), w, h)
                    if stored is not None
                    else np.zeros((h, w, 3), np.uint8)
                )
                src = queue_sources[qi] if queue_sources else None
            if mask[bb, neighbor]:
                found = True
                color = ORANGE
            if not found and nn_i == n_neighbors - 1:
                img = queue_data_u8[bb].copy()
                color = RED
            if color == GRAY:
                color = GREEN if src == "IN" else PURPLE
            images.append(draw_border(np.ascontiguousarray(img), color))
    n = n_neighbors + 1
    return subplot(images, n, n, w, h)


def imagenet_prediction_grid(
    data_u8: np.ndarray,
    logits: np.ndarray,
    labels: np.ndarray,
    max_images: int = 25,
    rng: Optional[np.random.RandomState] = None,
) -> np.ndarray:
    """Green/red bordered predictions with class-name text."""
    rng = rng or np.random.RandomState(0)
    preds = np.argmax(logits, axis=-1)
    correct = preds == labels
    h, w = data_u8.shape[1:3]
    order = rng.choice(len(data_u8), min(len(data_u8), max_images), replace=False)
    scale = w / 320.0
    images = []
    for bb in order:
        img = data_u8[bb].copy()
        draw_border(img, (0, 255, 0) if correct[bb] else (255, 0, 0))
        img = draw_contrast_text_cv2(
            img, "P: " + imagenet_label_to_class(preds[bb]), (10, 10 + int(30 * scale))
        )
        if not correct[bb]:
            img = draw_contrast_text_cv2(
                img, "GT: " + imagenet_label_to_class(labels[bb]), (10, 10 + int(60 * scale))
            )
        images.append(img)
    n_cols = max(int(np.sqrt(len(images))), 1)
    n_rows = max(-(-len(images) // n_cols), 1)  # ceil: keep the last row
    return subplot(images, n_rows, n_cols, w, h)


def attention_overlay(image_u8: np.ndarray, attention_mask: np.ndarray) -> np.ndarray:
    """Upsample and alpha-blend a red attention mask onto the image."""
    h, w = image_u8.shape[:2]
    mask = np.asarray(attention_mask, np.float32).squeeze()
    mask = _resize(mask, w, h)
    mask -= mask.min()
    mask /= mask.max() + 1e-8
    red = np.array([255, 0, 0], np.float32)
    out = mask[..., None] * red + (1 - mask[..., None]) * image_u8.astype(np.float32)
    return out.astype(np.uint8)


def attention_panel(
    data_u8: np.ndarray,
    queue_data_u8: np.ndarray,
    attention_masks: np.ndarray,
    queue_attention_masks: np.ndarray,
    max_images: int = 25,
    rng: Optional[np.random.RandomState] = None,
) -> np.ndarray:
    """2×2 (image, overlay) blocks for the query and key streams."""
    rng = rng or np.random.RandomState(0)
    h, w = data_u8.shape[1:3]
    order = rng.choice(len(data_u8), min(len(data_u8), max_images), replace=False)
    blocks = []
    for bb in order:
        imgs = [
            data_u8[bb],
            attention_overlay(data_u8[bb], attention_masks[bb]),
            queue_data_u8[bb],
            attention_overlay(queue_data_u8[bb], queue_attention_masks[bb]),
        ]
        blocks.append(subplot(imgs, 2, 2, w, h))
    n_cols = max(int(np.sqrt(len(blocks))), 1)
    n_rows = max(-(-len(blocks) // n_cols), 1)  # ceil: keep the last row
    return subplot(blocks, n_rows, n_cols, w * 2, h * 2, border=5)
