"""The port's tracker against the JAX package's on the CPU, in float32:

- ``TrackerSiamFC`` with the state of ``tests/test_tracking_golden.py``'s
  ``_golden_tracker()`` carried by ``load_jax_end_task_state``, on its
  ``_golden_frames()``, against ``tests/fixtures/tracker_golden_boxes.npy``
  at atol 1e-3 px: once with ``cv2.warpAffine`` in the crop's place (the JAX
  crop; this holds the tracker's math alone: the forward, the upsample, the
  window, the box and scale update) and once with the port's own crop;
- ``BatchedTrackerSiamFC`` against the serial tracker, within 1e-2 px (the
  tolerance of the JAX package's own test), 3 sequences in 2 slots;
- ``ExperimentOTB`` on a fabricated OTB layout and on the synthetic
  fallback, which is tagged, and driving the batched tracker."""

import os

import cv2
import jax
import numpy as np
import pytest
import torch

from tests.test_torch_port_runner import one_intra_op_thread  # noqa: F401
from tests.test_tracking_golden import GOLDEN_PATH, _golden_frames, _golden_tracker
from vince_tpu_torch.solvers import end_task_step as tet
from vince_tpu_torch.tracking import ops as tops
from vince_tpu_torch.tracking.experiments import ExperimentOTB
from vince_tpu_torch.tracking.sequences import OTBSequences, SyntheticSequences
from vince_tpu_torch.tracking.tracker import BatchedTrackerSiamFC, TrackerSiamFC
from vince_tpu_torch.utils.jax_weights import load_jax_end_task_state

GOLDEN_ATOL, BATCHED_ATOL = 1e-3, 1e-2


def _cv2_warp(image, m, out_size, border):
    return cv2.warpAffine(image, m, (out_size, out_size), flags=cv2.INTER_LINEAR,
                          borderMode=cv2.BORDER_CONSTANT,
                          borderValue=tuple(float(c) for c in border))


@pytest.fixture(scope="module")
def golden_state():
    """The JAX golden tracker's state in the port, and its config."""
    jax_tracker = _golden_tracker()
    cfg = tet.EndTaskConfig(task="tracking", backbone="ResNet18SiamFCDilated", embed_size=16,
                            num_classes=4, image_size=120, transform="GOT10KTransform",
                            freeze_feature_extractor=True, compute_dtype=torch.float32)
    state = tet.init_end_task_state(1, cfg, tet.build_optimizer(cfg, 0.01, "sgd"), device="cpu")
    load_jax_end_task_state(state, jax.tree_util.tree_map(np.asarray, jax_tracker.state))
    return cfg, state


def _track_golden(cfg, state):
    frames, gt = _golden_frames()
    tracker = TrackerSiamFC("golden", None, cfg, state)
    tracker.init(frames[0], gt[0])
    return np.stack([np.asarray(gt[0], np.float64)]
                    + [np.asarray(tracker.update(f), np.float64) for f in frames[1:]])


@pytest.mark.parametrize("crop", ["cv2", "port"])
def test_tracker_matches_the_golden_boxes(golden_state, crop, monkeypatch):
    """With the port's crop (within 1 of 255 of cv2's on a few pixels in 10⁵)
    the boxes stay within the same atol: no argmax of the 272×272 map moved
    (one cell is total_stride / response_up · x_sz / instance_sz ≈ 0.2 px
    here, far above 1e-3)."""
    if crop == "cv2":
        monkeypatch.setattr(tops, "warp_scale_translate", _cv2_warp)
    boxes = _track_golden(*golden_state)
    np.testing.assert_allclose(boxes, np.load(GOLDEN_PATH), atol=GOLDEN_ATOL)


def test_batched_tracker_matches_serial(golden_state):
    cfg, state = golden_state
    seqs = SyntheticSequences(num_seqs=3, num_frames=3, seed=3)
    sequences = [(seqs[i][0], seqs[i][1][0]) for i in range(3)]
    serial = TrackerSiamFC("serial", None, cfg, state)
    want = [serial.track(frames, box)[0] for frames, box in sequences]
    got = BatchedTrackerSiamFC("batched", None, cfg, state, n_slots=2).track_all(sequences)
    assert len(got) == 3
    for (boxes, times), ref in zip(got, want):
        np.testing.assert_allclose(boxes, ref, atol=BATCHED_ATOL)
        assert times.shape == (3,)


class GTTracker:
    """Echoes the first box: the harness alone, without the model."""

    name = "gt_echo"

    def track(self, frames, box):
        n = len(frames)
        return np.tile(np.asarray(box, np.float64), (n, 1)), np.full(n, 1e-3)


def test_otb_layout_plumbing(tmp_path):
    """A fabricated OTB-2015 layout (comma- and tab-separated ground truth)
    is read and preferred over the fallback, and its results are not
    tagged synthetic."""
    root = tmp_path / "otb100"
    for si, (name, delim) in enumerate((("Basketball", ","), ("Car4", "\t"))):
        seq = root / name / "img"
        seq.mkdir(parents=True)
        rng = np.random.RandomState(si)
        rows = []
        for fi in range(3):
            cv2.imwrite(str(seq / f"{fi + 1:04d}.jpg"), rng.randint(0, 255, (80, 100, 3),
                                                                      np.uint8))
            rows.append(delim.join(str(v) for v in (10 + fi, 20 + fi, 30, 40)))
        (root / name / "groundtruth_rect.txt").write_text("\n".join(rows) + "\n")
    seqs = OTBSequences(str(root))
    assert seqs.seq_names == ["Basketball", "Car4"]
    for i in range(2):
        frames, anno = seqs[i]
        assert len(frames) == 3 and anno.shape == (3, 4)
        np.testing.assert_allclose(anno[0], [10, 20, 30, 40])
    exp = ExperimentOTB(str(root), result_dir=str(tmp_path / "results"))
    assert isinstance(exp.sequences, OTBSequences)
    results = exp.run(GTTracker())
    assert 0.0 <= results["success"] <= 1.0 and results["precision"] > 0.5
    assert os.path.exists(tmp_path / "results" / "gt_echo.json")
    assert "synthetic" not in results


@pytest.mark.parametrize("texture", [False, True], ids=["squares", "texture"])
def test_synthetic_fallback_is_tagged(tmp_path, texture):
    """Without OTB data: 3 synthetic sequences of 12 frames in memory, and
    results tagged ``synthetic``, never to be taken for an OTB score."""
    exp = ExperimentOTB(None, result_dir=str(tmp_path / "results"), texture=texture)
    assert isinstance(exp.sequences, SyntheticSequences) and len(exp.sequences) == 3
    assert exp.sequences.seq_names[0] == ("tex_000" if texture else "synth_000")
    results = exp.run(GTTracker())
    assert results["synthetic"] is True and results["num_sequences"] == 3


def test_batched_tracker_through_experiment(tmp_path, golden_state):
    """``ExperimentOTB.run`` drives a ``track_all`` tracker over every
    sequence in one lockstep pass and scores each."""
    cfg, state = golden_state
    exp = ExperimentOTB(None, result_dir=str(tmp_path / "results"),
                        sequences=SyntheticSequences(num_seqs=3, num_frames=3, seed=4))
    results = exp.run(BatchedTrackerSiamFC("batched_exp", None, cfg, state, n_slots=4))
    assert set(results) >= {"precision", "success", "speed_fps", "synthetic"}
    assert 0.0 <= results["precision"] <= 1.0 and 0.0 <= results["success"] <= 1.0
    assert os.path.exists(tmp_path / "results" / "batched_exp.json")
