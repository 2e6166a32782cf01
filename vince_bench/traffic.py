"""The benchmark's traffic. A traffic mix is a data file,
``vince_bench/traffic/<name>.json``, whose ``kind`` names the runner that
drives it, ``vince_bench/runners/<kind>.py``; a new kind is a new runner
file. What the two kinds so far make from the run's seed:

- ``step``: ``canvases`` distinct batches of uint8 frames, each of the
  configuration's ``batch_size`` rows of ``canvas``² pixels, uniform noise
  made on the device in one call. Step i takes batch i mod ``canvases`` as
  its query frames and batch (i + ``key_offset``) mod ``canvases`` as its
  key frames, so that any ``key_offset`` consecutive steps see rows that all
  differ.
- ``files``: a tree of JPEG videos in the R2V2 layout, written at set-up
  under the run's temporary directory (``files.py``), which the training
  command reads through its loader.
"""

import hashlib
import json
from pathlib import Path

import torch

BENCH_DIR = Path(__file__).resolve().parent


def load(name: str) -> dict:
    """The mix of ``traffic/<name>.json``; its kind has to have a runner."""
    traffic = json.loads((BENCH_DIR / "traffic" / f"{name}.json").read_text())
    kind = traffic.get("kind")
    if not isinstance(kind, str) or not (BENCH_DIR / "runners" / f"{kind}.py").is_file():
        raise ValueError(f"traffic {name}: kind {kind!r} has no runners/{kind}.py")
    return traffic


def derive(seed: int, use: str) -> int:
    """A seed for one use of the run's seed (weights, queue, frames)."""
    digest = hashlib.blake2b(f"{int(seed)}:{use}".encode(), digest_size=8).digest()
    return int.from_bytes(digest, "little") >> 1


def generator(device, seed: int, use: str) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(derive(seed, use))


class StepFeed:
    """The ``step`` traffic: batches of frames on the device."""

    def __init__(self, traffic: dict, frames: int, seed: int, device):
        n, side = traffic["canvases"], traffic["canvas"]
        self.key_offset = traffic["key_offset"]
        if not 0 < self.key_offset < n:
            raise ValueError("key_offset must lie between 0 and the number of canvases")
        self.canvases = torch.randint(0, 256, (n, frames, side, side, 3), dtype=torch.uint8,
                                      generator=generator(device, seed, "frames"),
                                      device=device)

    def frames(self, i: int):
        """(query frames, key frames) of step ``i``."""
        n = len(self.canvases)
        return self.canvases[i % n], self.canvases[(i + self.key_offset) % n]

    def batch(self, i: int):
        """Step ``i``'s batch as the training step takes it: one source."""
        data, queue_data = self.frames(i)
        return ({"data": data, "queue_data": queue_data},)
