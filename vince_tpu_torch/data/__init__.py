"""Dataset registry (counterpart of ``vince_tpu/data/__init__.py``): the names
the CLI takes, and their classes. The file-backed datasets read JPEGs under
``--data-path`` / ``--imagenet-data-path`` with ``cv2``, or on the run's
device with ``--native-decode``. ``GOT10kDataset`` reads the GOT-10k
sequences under ``--data-path``, or makes synthetic ones in memory.
``VideoCacherDataset`` downloads videos and caches their filtered frames in
R2V2's layout (``scrape/cache_video_dataset.py`` drives it)."""

from vince_tpu_torch.data.got10k_dataset import GOT10kDataset
from vince_tpu_torch.data.imagenet_dataset import ImagenetDataset, SunSceneDataset
from vince_tpu_torch.data.kinetics_dataset import Kinetics400Dataset
from vince_tpu_torch.data.npz_dataset import NPZDataset, NPZImageDataset
from vince_tpu_torch.data.r2v2_dataset import GOT10KR2V2Dataset, R2V2Dataset
from vince_tpu_torch.data.synthetic_dataset import (
    SyntheticClipDataset,
    SyntheticImageDataset,
    SyntheticTextureClipDataset,
    SyntheticTextureImageDataset,
    SyntheticTextureVideoDataset,
    SyntheticVideoDataset,
)
from vince_tpu_torch.data.video_cacher_dataset import VideoCacherDataset

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


def get_dataset(name: str):
    if name not in __all__:
        raise KeyError(f"unknown dataset {name!r}; choices: {__all__}")
    return globals()[name]
