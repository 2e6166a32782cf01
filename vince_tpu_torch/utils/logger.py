"""Scalar, image and histogram logger (counterpart of
``vince_tpu/utils/logger.py``): tensorboardX when it imports, and always an
in-memory ``history`` of the scalars, so that a run without it logs all the
same."""

from typing import Dict, Optional

import numpy as np

try:
    from tensorboardX import SummaryWriter
except ImportError:
    SummaryWriter = None


class Logger:
    def __init__(self, logdir: Optional[str] = None):
        self.logdir = logdir
        self.writer = SummaryWriter(logdir) if (logdir and SummaryWriter) else None
        self.history: Dict[str, list] = {}

    def scalar_summary(self, tag: str, value: float, step: int):
        value = float(value)
        self.history.setdefault(tag, []).append((step, value))
        if self.writer:
            self.writer.add_scalar(tag, value, step)

    def dict_log(self, scalars: Dict[str, float], step: int, prefix: str = ""):
        for k, v in scalars.items():
            tag = f"{prefix}{k}" if prefix else k
            try:
                self.scalar_summary(tag, float(np.asarray(v)), step)
            except (TypeError, ValueError):
                pass

    def image_summary(self, tag: str, image: np.ndarray, step: int, max_size: int = 2048):
        """image: HWC uint8."""
        image = np.asarray(image)
        if max(image.shape[:2]) > max_size:
            import cv2

            scale = max_size / max(image.shape[:2])
            image = cv2.resize(image, (int(image.shape[1] * scale), int(image.shape[0] * scale)))
        if self.writer:
            self.writer.add_image(tag, image, step, dataformats="HWC")

    def histogram_summary(self, tag: str, values: np.ndarray, step: int):
        if self.writer:
            self.writer.add_histogram(tag, np.asarray(values), step)

    def network_weight_summary(self, model, step: int, prefix: str = "weights"):
        """A histogram of each of ``model.named_parameters()``."""
        if not self.writer:
            return
        for name, p in model.named_parameters():
            if p.numel() > 0:
                self.histogram_summary(f"{prefix}/{name}",
                                       p.detach().float().cpu().numpy().reshape(-1), step)

    def flush(self):
        if self.writer:
            self.writer.flush()

    def close(self):
        if self.writer:
            self.writer.close()
