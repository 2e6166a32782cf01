"""In-memory NPZ datasets (counterpart of ``vince_tpu/data/npz_dataset.py``):
the CIFAR kNN probe's images, and a trainable image dataset over the same
file. ``cv2`` is imported only where the images need a resize."""

from typing import Optional

import numpy as np

from vince_tpu_torch.data.base_dataset import canvas_size


class NPZDataset:
    def __init__(
        self,
        args,
        path: str,
        data_subset: str = "train",
        num_data_points: Optional[int] = None,
        target_size: Optional[tuple] = None,  # (w, h); default = args input size
    ):
        npz = np.load(path.format(data_subset=data_subset))
        data = npz["data"]
        labels = np.asarray(npz["labels"]).astype(np.int32)
        if num_data_points is not None and num_data_points < len(data):
            rng = np.random.RandomState(0)  # a fixed subset
            keep = rng.choice(len(data), num_data_points, replace=False)
            data, labels = data[keep], labels[keep]
        if data.ndim != 4:
            raise ValueError(f"{path}: data of shape {data.shape}, expected 4 dimensions")
        if data.shape[1] == 3 and data.shape[-1] != 3:
            data = data.transpose(0, 2, 3, 1)
        size = target_size or (
            getattr(args, "input_width", 224), getattr(args, "input_height", 224)
        )
        if data.shape[1:3] != (size[1], size[0]):
            import cv2

            data = np.stack(
                [cv2.resize(im, size, interpolation=cv2.INTER_LINEAR) for im in data]
            )
        self.data = np.ascontiguousarray(data.astype(np.uint8))
        self.labels = labels
        self.batch_size = getattr(args, "batch_size", 256)

    def __len__(self):
        return len(self.data)

    def iter_batches(self, batch_size: Optional[int] = None, pad_to_batch: bool = True):
        """Sequential [B, H, W, 3] uint8 batches with their labels and the
        count of real rows; the last batch is padded with zeros to B."""
        b = batch_size or self.batch_size
        n = len(self.data)
        for off in range(0, n, b):
            chunk = self.data[off : off + b]
            labels = self.labels[off : off + b]
            valid = len(chunk)
            if valid < b and pad_to_batch:
                pad = b - valid
                chunk = np.concatenate([chunk, np.zeros((pad,) + chunk.shape[1:], np.uint8)])
                labels = np.concatenate([labels, np.zeros((pad,), np.int32)])
            yield chunk, labels, valid


class NPZImageDataset:
    """Trainable image dataset over an NPZ file: items are ``{data,
    queue_data}`` views of one image (augmented apart on the device) and its
    labels. The path comes from ``--data-path`` if it ends in .npz, else
    from ``--cifar-data-path``."""

    def __init__(self, args, data_subset: str = "train", num_data_points=None):
        path = getattr(args, "data_path", "") or ""
        if not path.endswith(".npz"):
            path = args.cifar_data_path
        subset = {"test": "val"}.get(data_subset, data_subset)
        c = canvas_size(getattr(args, "input_width", 224))
        inner = NPZDataset(args, path, subset, num_data_points, target_size=(c, c))
        self.data = inner.data
        self.labels = inner.labels
        self.num_views = max(getattr(args, "num_frames", 1), 1)

    def __len__(self):
        return len(self.data)

    def __getitem__(self, idx):
        img = self.data[idx]
        reps = np.repeat(img[None], self.num_views, axis=0)
        label = np.repeat(np.int32(self.labels[idx]), self.num_views)
        return {
            "data": reps,
            "queue_data": reps,
            "labels": label,
            "imagenet_labels": label,
            "classifier_labels": label,
            "ind": np.int64(idx),
        }
