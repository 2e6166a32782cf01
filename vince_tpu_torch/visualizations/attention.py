"""Attention overlays of a pretraining checkpoint (counterpart of
``vince_tpu/visualizations/attention.py``): val images through the restored
``--use-attention`` solver's ``panel_fn``, each beside its attention-pool mask
blended onto it (``panels.attention_overlay``), in one grid. Run:

    python -m vince_tpu_torch.visualizations.attention \\
        --title t --description d --use-attention \\
        --dataset SyntheticVideoDataset --num-images 64 --output-dir attn [--platform cpu]

It writes ``<output-dir>/attention_<description>.jpg``.
"""

import os
from typing import List

import numpy as np
import torch


def attention_grid(solver, dataset, num_images: int, batch_size: int) -> np.ndarray:
    """The first ``num_images`` readable images of ``dataset`` (a video's
    first frame), in batches of ``batch_size`` (the last padded by repeating
    its last image), as (image, overlay) blocks in a near-square grid."""
    from vince_tpu_torch.utils.drawing import subplot
    from vince_tpu_torch.visualizations.panels import attention_overlay

    blocks: List[np.ndarray] = []
    batch: List[np.ndarray] = []

    def flush():
        valid = len(batch)
        while len(batch) < batch_size:
            batch.append(batch[-1])
        arr = np.stack(batch)
        out = solver.panel_fn(solver.state, torch.from_numpy(arr).to(solver.device))
        masks = out["attention_masks"].cpu().numpy()
        h, w = arr.shape[1:3]
        for b in range(valid):
            blocks.append(subplot([arr[b], attention_overlay(arr[b], masks[b])], 1, 2, w, h))
        batch.clear()

    for i in range(min(num_images, len(dataset))):
        item = dataset[i]
        if item is None:  # a failed read; the tail is flushed after the loop
            continue
        batch.append(item["data"][0] if item["data"].ndim == 4 else item["data"])
        if len(batch) == batch_size:
            flush()
    if batch:
        flush()
    if not blocks:
        raise ValueError("no readable images in the dataset")
    h2, w2 = blocks[0].shape[:2]
    n_cols = max(int(np.sqrt(len(blocks))), 1)
    n_rows = int(np.ceil(len(blocks) / n_cols))
    return subplot(blocks, n_rows, n_cols, w2, h2, border=4)


def main(argv=None) -> str:
    """Write the grid as the flags say; returns the file's path."""
    import cv2

    from vince_tpu_torch.arg_parser import build_parser, finalize_args
    from vince_tpu_torch.data import get_dataset
    from vince_tpu_torch.solvers.vince_solver import VinceSolver

    parser = build_parser()
    parser.add_argument("--num-images", type=int, default=64)
    parser.add_argument("--output-dir", type=str, default="attention_viz")
    args = finalize_args(parser.parse_args(argv))
    if not args.use_attention:
        raise ValueError("attention overlays need --use-attention")
    solver = VinceSolver(args)
    try:
        dataset = get_dataset(args.dataset or "SyntheticVideoDataset")(args, "val")
        grid = attention_grid(solver, dataset, args.num_images, args.batch_size)
    finally:
        solver.end()
    os.makedirs(args.output_dir, exist_ok=True)
    out = os.path.join(args.output_dir, f"attention_{args.description}.jpg")
    cv2.imwrite(out, grid[:, :, ::-1])
    print("wrote", out)
    return out


if __name__ == "__main__":
    main()
