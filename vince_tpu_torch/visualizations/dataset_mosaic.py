"""Dataset mosaics and t-SNE image maps (counterpart of
``vince_tpu/visualizations/dataset_mosaic.py``): a 16x16 mosaic of images
drawn by ``RandomState(0)``, and with ``--with-tsne`` the images' embeddings
(the restored solver's ``embed_fn``) laid out by ``sklearn``'s t-SNE, each
thumbnail at its 2-D place. Run:

    python -m vince_tpu_torch.visualizations.dataset_mosaic \\
        --title t --description d --dataset SyntheticVideoDataset ... \\
        --num-images 1024 --output-dir mosaics [--with-tsne] [--platform cpu]

It writes ``<output-dir>/mosaic.jpg`` and, with ``--with-tsne``, ``tsne.jpg``.
The t-SNE needs ``sklearn``; without it ``--with-tsne`` raises an
``ImportError`` after the mosaic is written.
"""

import os

import numpy as np


def sample_mosaic(dataset, rows: int = 16, cols: int = 16) -> np.ndarray:
    """``rows x cols`` images of ``dataset`` drawn without replacement by
    ``RandomState(0)`` (a video's first frame), a failed read left out."""
    from vince_tpu_torch.utils.drawing import subplot

    idx = np.random.RandomState(0).choice(len(dataset), min(rows * cols, len(dataset)),
                                          replace=False)
    images = []
    for i in idx:
        item = dataset[int(i)]
        if item is None:
            continue
        images.append(item["data"][0] if item["data"].ndim == 4 else item["data"])
    if not images:
        raise ValueError("no readable images in the dataset")
    h, w = images[0].shape[:2]
    return subplot(images, rows, cols, w, h)


def _tsne():
    try:
        from sklearn.manifold import TSNE
    except ImportError as e:
        raise ImportError("--with-tsne needs scikit-learn (sklearn), which is not "
                          "installed") from e
    return TSNE


def tsne_image(features: np.ndarray, images: np.ndarray, canvas_size: int = 4096,
               thumb: int = 64, perplexity: float = 30.0) -> np.ndarray:
    """Thumbnails of ``images`` placed at the t-SNE coordinates of
    ``features`` on a black square canvas (host numpy and ``sklearn``)."""
    import cv2

    coords = _tsne()(
        n_components=2, perplexity=min(perplexity, max(len(features) - 1, 1) / 3), init="pca"
    ).fit_transform(features.astype(np.float64))
    coords -= coords.min(axis=0)
    coords /= coords.max(axis=0) + 1e-9
    canvas = np.zeros((canvas_size, canvas_size, 3), np.uint8)
    for (x, y), img in zip(coords, images):
        px, py = int(x * (canvas_size - thumb)), int(y * (canvas_size - thumb))
        canvas[py:py + thumb, px:px + thumb] = cv2.resize(np.asarray(img), (thumb, thumb))
    return canvas


def main(argv=None) -> list:
    """Write the mosaic (and the t-SNE map) as the flags say; returns the
    files' paths."""
    import cv2

    from vince_tpu_torch.arg_parser import build_parser, finalize_args
    from vince_tpu_torch.data import get_dataset
    from vince_tpu_torch.solvers.vince_solver import VinceSolver
    from vince_tpu_torch.visualizations.view_nearest_neighbors import embed_dataset

    parser = build_parser()
    parser.add_argument("--num-images", type=int, default=1024)
    parser.add_argument("--output-dir", type=str, default="mosaics")
    parser.add_argument("--with-tsne", action="store_true")
    args = finalize_args(parser.parse_args(argv))
    dataset = get_dataset(args.dataset or "SyntheticVideoDataset")(args, "val")
    os.makedirs(args.output_dir, exist_ok=True)
    written = [os.path.join(args.output_dir, "mosaic.jpg")]
    cv2.imwrite(written[0], sample_mosaic(dataset)[:, :, ::-1])
    print("wrote", written[0])
    if args.with_tsne:
        _tsne()  # before the solver is built
        solver = VinceSolver(args)
        try:
            images, feats = embed_dataset(solver, dataset, args.num_images, args.batch_size)
        finally:
            solver.end()
        written.append(os.path.join(args.output_dir, "tsne.jpg"))
        cv2.imwrite(written[1], tsne_image(feats, images, canvas_size=2048)[:, :, ::-1])
        print("wrote", written[1])
    return written


if __name__ == "__main__":
    main()
