"""Tracking evaluation (counterpart of ``vince_tpu/tracking/experiments.py``):
OTB-2015's one-pass evaluation over any sequence reader with ``seq_names``
and ``__getitem__ → (frames, anno)``.

- precision: the share of frames whose predicted centre lies within 20 px
  of the ground truth's;
- success: the area under the IoU success curve over 21 thresholds in
  [0, 1].

Without OTB data it runs on 3 synthetic sequences of 12 frames in memory (or
the texture family) and tags the results ``synthetic``, so that they are
never taken for an OTB score.
"""

import json
import os
import time
from typing import Dict, Optional

import numpy as np

from vince_tpu_torch.tracking.ops import iou_xyxy, xywh_to_xyxy
from vince_tpu_torch.tracking.sequences import (
    OTBSequences,
    SyntheticSequences,
    TextureSequences,
)


def center_error(pred_xywh, gt_xywh) -> float:
    p = pred_xywh[:2] + pred_xywh[2:] / 2
    g = gt_xywh[:2] + gt_xywh[2:] / 2
    return float(np.linalg.norm(p - g))


def compute_metrics(pred_boxes: np.ndarray, gt_boxes: np.ndarray) -> Dict[str, np.ndarray]:
    n = min(len(pred_boxes), len(gt_boxes))
    ious = np.array([iou_xyxy(xywh_to_xyxy(pred_boxes[i]), xywh_to_xyxy(gt_boxes[i]))
                     for i in range(n)])
    errors = np.array([center_error(pred_boxes[i], gt_boxes[i]) for i in range(n)])
    return {"ious": ious, "center_errors": errors}


class ExperimentOTB:
    """OTB-2015's one-pass evaluation (OPE)."""

    def __init__(self, root: Optional[str], result_dir: str = "results/OTB2015",
                 sequences=None, texture: bool = False):
        if sequences is not None:
            self.sequences = sequences
        elif root and os.path.isdir(root):
            self.sequences = OTBSequences(root)
        elif texture:
            print("OTB data not found; using TEXTURE sequences for smoke eval")
            self.sequences = TextureSequences(num_seqs=3, num_frames=12)
        else:
            print("OTB data not found; using synthetic sequences for smoke eval")
            self.sequences = SyntheticSequences(num_seqs=3, num_frames=12)
        self.result_dir = result_dir
        self.nbins_iou = 21

    def run(self, tracker) -> Dict[str, float]:
        """Track every sequence (all in one ``track_all`` call where the
        tracker has it), score each, and write the scores to
        ``<result_dir>/<tracker.name>.json``; returns the averages."""
        per_seq = {}
        os.makedirs(self.result_dir, exist_ok=True)
        per_frame = None
        if hasattr(tracker, "track_all"):
            seqs = [self.sequences[i] for i in range(len(self.sequences))]
            t0 = time.time()
            per_frame = tracker.track_all([(f, a[0]) for f, a in seqs])
            wall = time.time() - t0
            total_frames = sum(len(f) for f, _ in seqs)
            print(f"  batched: {len(seqs)} sequences / {total_frames} frames "
                  f"in {wall:.3f}s = {total_frames / wall:.3f} aggregate fps")
        for i in range(len(self.sequences)):
            frames, anno = self.sequences[i]
            name = self.sequences.seq_names[i]
            if per_frame is not None:
                boxes, times = per_frame[i]
            else:
                boxes, times = tracker.track(frames, anno[0])
            m = compute_metrics(boxes, anno)
            fps = len(frames) / max(times.sum(), 1e-9)
            per_seq[name] = {"success_auc": float(self._success_auc(m["ious"])),
                             "precision_20px": float(np.mean(m["center_errors"] <= 20)),
                             "fps": float(fps)}
            print(f"  [{i + 1}/{len(self.sequences)}] {name}: "
                  f"prec={per_seq[name]['precision_20px']:.3f} "
                  f"succ={per_seq[name]['success_auc']:.3f} fps={fps:.1f}")
        results = {  # OTB's convention: the means of the per-sequence scores
            "precision": float(np.mean([s["precision_20px"] for s in per_seq.values()])),
            "success": float(np.mean([s["success_auc"] for s in per_seq.values()])),
            "speed_fps": float(np.mean([s["fps"] for s in per_seq.values()])),
        }
        if isinstance(self.sequences, SyntheticSequences):
            results["synthetic"] = True
            results["num_sequences"] = len(self.sequences)
        with open(os.path.join(self.result_dir, f"{tracker.name}.json"), "w") as f:
            json.dump({"overall": results, "per_sequence": per_seq}, f, indent=2)
        return results

    def _success_auc(self, ious: np.ndarray) -> float:
        thresholds = np.linspace(0, 1, self.nbins_iou)
        return float(np.mean([(ious > t).mean() for t in thresholds]))
