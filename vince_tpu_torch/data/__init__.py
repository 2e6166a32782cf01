"""Dataset registry (counterpart of ``vince_tpu/data/__init__.py``): the names
the CLI takes, and the classes of those that are ported. The file-backed
datasets (R2V2, ImageNet, SUN, Kinetics and the video cacher) are not ported
yet (``ROADMAP.md`` §1 item 6). ``GOT10kDataset`` reads the GOT-10k
sequences under ``--data-path`` (with ``cv2``), or makes synthetic ones in
memory."""

from vince_tpu_torch.data.got10k_dataset import GOT10kDataset
from vince_tpu_torch.data.npz_dataset import NPZDataset, NPZImageDataset
from vince_tpu_torch.data.synthetic_dataset import (
    SyntheticClipDataset,
    SyntheticImageDataset,
    SyntheticTextureClipDataset,
    SyntheticTextureImageDataset,
    SyntheticTextureVideoDataset,
    SyntheticVideoDataset,
)

__all__ = [
    "GOT10kDataset",
    "ImagenetDataset",
    "Kinetics400Dataset",
    "NPZDataset",
    "NPZImageDataset",
    "R2V2Dataset",
    "GOT10KR2V2Dataset",
    "SunSceneDataset",
    "VideoCacherDataset",
    "SyntheticVideoDataset",
    "SyntheticTextureVideoDataset",
    "SyntheticImageDataset",
    "SyntheticClipDataset",
    "SyntheticTextureImageDataset",
    "SyntheticTextureClipDataset",
]

NOT_PORTED = ("ImagenetDataset", "Kinetics400Dataset", "R2V2Dataset",
              "GOT10KR2V2Dataset", "SunSceneDataset", "VideoCacherDataset")


def get_dataset(name: str):
    if name in NOT_PORTED:
        raise ValueError(f"{name} reads files from disk and is not ported yet (ROADMAP.md §1 "
                         f"item 6); the ported datasets are "
                         f"{sorted(set(__all__) - set(NOT_PORTED))}")
    if name not in __all__:
        raise KeyError(f"unknown dataset {name!r}; choices: {__all__}")
    return globals()[name]
