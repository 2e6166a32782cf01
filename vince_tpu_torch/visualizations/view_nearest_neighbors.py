"""Nearest-neighbour grids of a pretraining checkpoint (counterpart of
``vince_tpu/visualizations/view_nearest_neighbors.py``): val images embedded
through the restored solver's ``embed_fn``, reduced by PCA to 64 dimensions
when wider, and for 10 queries their 10 nearest other images by cosine, a row
each. Run:

    python -m vince_tpu_torch.visualizations.view_nearest_neighbors \\
        --title t --description d --dataset SyntheticVideoDataset ... \\
        --num-images 512 --output-dir nn_grids [--platform cpu]

It writes ``<output-dir>/nn_<description>.jpg``.
"""

import os
from typing import List

import numpy as np
import torch


def embed_dataset(solver, dataset, num_images: int, batch_size: int):
    """The first ``num_images`` readable images of ``dataset`` (a video's
    first frame) and their f32 embeddings, embedded in batches of
    ``batch_size`` (the last padded by repeating its last image; the padding's
    rows are dropped)."""
    images, embeddings = [], []
    batch: List[np.ndarray] = []

    def flush():
        valid = len(batch)
        while len(batch) < batch_size:
            batch.append(batch[-1])
        emb, _ = solver.embed_fn(solver.state, torch.from_numpy(np.stack(batch)).to(solver.device))
        embeddings.append(emb.cpu().numpy()[:valid])
        images.extend(batch[:valid])
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
    if not images:
        raise ValueError("no readable images in the dataset")
    return np.stack(images), np.concatenate(embeddings)


def pca_reduce(features: np.ndarray, dim: int = 64) -> np.ndarray:
    """PCA to ``dim`` components when the features are wider: the centred
    features projected on their top ``dim`` right singular vectors, in f64
    (``sklearn``'s ``PCA.fit_transform`` up to each column's sign), in the
    features' dtype."""
    if features.shape[1] <= dim:
        return features
    if dim > min(features.shape):
        raise ValueError(f"{dim} components of {features.shape[0]} samples: at most "
                         f"{min(features.shape)}")
    x = torch.as_tensor(np.asarray(features), dtype=torch.float64)
    x = x - x.mean(dim=0)
    _, _, vh = torch.linalg.svd(x, full_matrices=False)
    return (x @ vh[:dim].T).numpy().astype(features.dtype)


def nn_grid(images: np.ndarray, features: np.ndarray, n_queries: int = 10,
            n_neighbors: int = 10) -> np.ndarray:
    """``n_queries`` images drawn by ``RandomState(0)``, each followed by its
    ``n_neighbors`` nearest other images by cosine, a row per query."""
    from vince_tpu_torch.utils.drawing import subplot

    f = features / np.maximum(np.linalg.norm(features, axis=1, keepdims=True), 1e-12)
    sims = f @ f.T
    np.fill_diagonal(sims, -np.inf)
    queries = np.random.RandomState(0).choice(len(images), min(n_queries, len(images)),
                                              replace=False)
    cells: List[np.ndarray] = []
    for q in queries:
        cells.append(images[q])
        cells.extend(images[nb] for nb in np.argsort(-sims[q])[:n_neighbors])
    h, w = images.shape[1:3]
    return subplot(cells, len(queries), n_neighbors + 1, w, h)


def main(argv=None) -> str:
    """Write the grid as the flags say; returns the file's path."""
    import cv2

    from vince_tpu_torch.arg_parser import build_parser, finalize_args
    from vince_tpu_torch.data import get_dataset
    from vince_tpu_torch.solvers.vince_solver import VinceSolver

    parser = build_parser()
    parser.add_argument("--num-images", type=int, default=512)
    parser.add_argument("--output-dir", type=str, default="nn_grids")
    args = finalize_args(parser.parse_args(argv))
    solver = VinceSolver(args)
    try:
        dataset = get_dataset(args.dataset or "SyntheticVideoDataset")(args, "val")
        images, feats = embed_dataset(solver, dataset, args.num_images, args.batch_size)
    finally:
        solver.end()
    grid = nn_grid(images, pca_reduce(feats))
    os.makedirs(args.output_dir, exist_ok=True)
    out = os.path.join(args.output_dir, f"nn_{args.description}.jpg")
    cv2.imwrite(out, grid[:, :, ::-1])
    print("wrote", out)
    return out


if __name__ == "__main__":
    main()
