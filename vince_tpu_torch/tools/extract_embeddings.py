#!/usr/bin/env python
"""Batch embedding extraction through a restored VINCE encoder (counterpart of
``tools/extract_embeddings.py``): a directory tree of JPEGs (or a registered
dataset's val split) through the solver's ``embed_fn`` into
``embeddings.npz``, with the L2-normalised ``embeddings [N, D] float32``
and the ``paths`` (or item indices) they came from.

    python vince_tpu_torch/tools/extract_embeddings.py --title t --description d \\
        --base-logdir LOGS --solver VinceSolver --backbone ResNet50 \\
        --vince-embedding-size 128 --input-width 224 --input-height 224 \\
        --batch-size 128 --input-dir /data/frames --output embeddings.npz \\
        [--native-decode] [--platform cpu]

The flags are the training run's (the checkpoint directory follows from
them, or from ``--checkpoint-dir``; ``--no-restore`` embeds with random
weights). A file is resized to the canvas ``ceil(size / 0.875)`` and
centre-cropped to ``size``. With ``--native-decode`` the files of a batch
are decoded together on the run's device (``native.DecodePool``: nvJPEG and
the resize kernel on a GPU); otherwise each is read with ``cv2``. A file
that cannot be read is left out of the output.
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

JPEG_EXTS = (".jpg", ".jpeg", ".JPG", ".JPEG")


def list_images(root: str):
    out = []
    for dirpath, _, files in os.walk(root):
        out.extend(os.path.join(dirpath, f) for f in files if f.endswith(JPEG_EXTS))
    return sorted(out)


def center_crop(img, size: int):
    h, w = img.shape[:2]
    y0, x0 = max((h - size) // 2, 0), max((w - size) // 2, 0)
    return img[y0:y0 + size, x0:x0 + size]


def decode_batch_cv2(paths, canvas: int):
    """[B] file paths → ([B, canvas, canvas, 3] uint8, [B] ok mask), by cv2."""
    import cv2

    out = np.zeros((len(paths), canvas, canvas, 3), np.uint8)
    oks = np.zeros(len(paths), bool)
    for i, p in enumerate(paths):
        bgr = cv2.imread(p, cv2.IMREAD_COLOR)
        if bgr is None:
            continue
        out[i] = cv2.resize(bgr[:, :, ::-1], (canvas, canvas), interpolation=cv2.INTER_LINEAR)
        oks[i] = True
    return out, oks


def embed_dataset(embed, dataset, num_images: int, batch_size: int):
    """The first image of each of the first ``num_images`` items (None items
    skipped), embedded in batches padded with copies of their last image."""
    embeddings, batch = [], []

    def flush():
        valid = len(batch)
        batch.extend([batch[-1]] * (batch_size - valid))
        embeddings.append(embed(np.stack(batch))[:valid])
        batch.clear()

    for i in range(min(num_images, len(dataset))):
        item = dataset[i]
        if item is None:
            continue
        batch.append(item["data"][0] if item["data"].ndim == 4 else item["data"])
        if len(batch) == batch_size:
            flush()
    if batch:
        flush()
    if not embeddings:
        raise ValueError("no readable images in the dataset")
    return np.concatenate(embeddings)


def main(argv=None):
    from vince_tpu_torch.arg_parser import build_parser, finalize_args

    parser = build_parser()
    parser.add_argument("--input-dir", default=None,
                        help="directory tree of JPEGs; omit to embed the --dataset val split")
    parser.add_argument("--output", default="embeddings.npz")
    parser.add_argument("--num-images", type=int, default=0, help="cap (0 = all)")
    args = finalize_args(parser.parse_args(argv))
    args.disable_dataloader = True  # no train loaders, no queue prefill

    import torch

    from vince_tpu_torch import native
    from vince_tpu_torch.solvers.vince_solver import VinceSolver

    solver = VinceSolver(args)
    size, bs = args.input_width, args.batch_size

    def embed(arr):  # [B, S, S, 3] uint8 → [B, D] float32, L2-normalised
        emb, _ = solver.embed_fn(solver.state, torch.from_numpy(arr).to(solver.device))
        return emb.float().cpu().numpy()

    embeddings, names = [], []
    try:
        if args.input_dir:
            paths = list_images(args.input_dir)
            if args.num_images:
                paths = paths[: args.num_images]
            if not paths:
                raise SystemExit(f"no JPEGs under {args.input_dir}")
            canvas = int(np.ceil(size / 0.875))
            pool = native.DecodePool(solver.device) if native.wanted(args) else None
            for i in range(0, len(paths), bs):
                chunk = paths[i:i + bs]
                imgs, oks = (pool.decode_files(chunk, canvas) if pool is not None
                             else decode_batch_cv2(chunk, canvas))
                imgs = np.stack([center_crop(im, size) for im in imgs])
                if len(chunk) < bs:  # the tail batch padded to the run's batch
                    imgs = np.concatenate([imgs, np.repeat(imgs[-1:], bs - len(chunk), 0)])
                embeddings.append(embed(imgs)[: len(chunk)][oks])
                names.extend(p for p, ok in zip(chunk, oks) if ok)
        else:
            from vince_tpu_torch.data import get_dataset

            dataset = get_dataset(args.dataset or "SyntheticVideoDataset")(args, "val")
            emb = embed_dataset(embed, dataset, args.num_images or len(dataset), bs)
            embeddings.append(emb)
            names.extend(str(i) for i in range(len(emb)))
    finally:
        solver.end()
    emb = np.concatenate(embeddings).astype(np.float32) if embeddings else np.zeros((0, 0))
    np.savez(args.output, embeddings=emb, paths=np.asarray(names))
    print(f"wrote {args.output}: {emb.shape[0]} embeddings of dim "
          f"{emb.shape[1] if emb.ndim == 2 and emb.shape[0] else 0}")
    return emb, names


if __name__ == "__main__":
    main()
