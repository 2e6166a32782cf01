"""The tracking end task through the port's CLI on the CPU, as
``tests/test_end_tasks.py::test_tracking_solver_and_otb_eval`` drives the JAX
one (batch 4, 120 px): a pretraining run of ``solver_runner.main`` leaves a
checkpoint (ResNet18, 32x32, embeddings 16); ``solver_runner.main`` with
``--solver EndTaskTrackingSolver --backbone ResNet18`` maps the backbone to
its dilated variant, restores the query encoder bit for bit, trains one
iteration on GOT-10k pairs of synthetic sequences, runs the exact val pass
and saves; ``run_end_task_eval.main`` restores that state and prints
``EVAL_RESULT``, the OTB dict of the synthetic fallback, equal to what
``run_eval`` returns, with the batched tracker and with the serial one
(``--tracker-slots 1``). The val split is cut to 2 pairs of each of the 8
sequences (16 pairs, 4 batches), and the OTB fallback's 3 sequences to 3
frames each."""

import contextlib
import io
import json
import os

import numpy as np
import pytest
import torch

from tests.test_torch_port_runner import one_intra_op_thread  # noqa: F401
from vince_tpu_torch import arg_parser, run_end_task_eval, solver_runner
from vince_tpu_torch.data.got10k_dataset import GOT10kDataset
from vince_tpu_torch.solvers.end_task_solvers import EndTaskTrackingSolver
from vince_tpu_torch.tracking import experiments
from vince_tpu_torch.tracking.sequences import SyntheticSequences

VAL_PAIRS_PER_SEQ, OTB_FRAMES = 2, 3


class ShortSequences(SyntheticSequences):
    """The OTB fallback's sequences, cut to ``OTB_FRAMES`` frames."""

    def __init__(self, num_seqs=4, num_frames=20, **kw):
        super().__init__(num_seqs, OTB_FRAMES, **kw)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tracking")
    solver_runner.main([
        "--title", "run", "--description", "cpu", "--solver", "VinceSolver",
        "--dataset", "SyntheticTextureVideoDataset", "--use-videos", "--inter-batch-comparison",
        "--num-frames", "2", "--batch-size", "4", "--input-width", "32", "--input-height", "32",
        "--vince-queue-size", "32", "--vince-embedding-size", "16", "--iterations-per-epoch", "1",
        "--epochs", "1", "--save-frequency", "1", "--base-lr", "0.03", "--num-workers", "1",
        "--synthetic-num-videos", "8", "--platform", "cpu", "--debug", "--base-logdir", str(tmp)])
    pretrain = torch.load(tmp / "run" / "checkpoints_cpu" / "1" / "state.pt",
                          weights_only=True)["model"]
    argv = ["--title", "run", "--description", "cpu", "--solver", "EndTaskTrackingSolver",
            "--backbone", "ResNet18", "--dataset", "GOT10kDataset", "--batch-size", "4",
            "--input-width", "120", "--input-height", "120", "--vince-embedding-size", "16",
            "--iterations-per-epoch", "1", "--epochs", "1", "--base-lr", "0.01",
            "--num-workers", "2", "--freeze-feature-extractor", "--save-frequency", "100",
            "--platform", "cpu", "--debug", "--base-logdir", str(tmp)]
    mp = pytest.MonkeyPatch()
    original = EndTaskTrackingSolver._make_dataset
    encoders = []

    def make_dataset(self, subset):
        if subset == "val":
            return GOT10kDataset(self.args, "val", pairs_per_seq=VAL_PAIRS_PER_SEQ)
        return original(self, subset)

    def keep_encoder(self):
        out = orig_setup(self)
        encoders.append({k: v.clone() for k, v in self.state.encoder.state_dict().items()})
        return out

    orig_setup = EndTaskTrackingSolver.setup_model
    mp.setattr(EndTaskTrackingSolver, "_make_dataset", make_dataset)
    mp.setattr(EndTaskTrackingSolver, "setup_model", keep_encoder)
    mp.setattr(experiments, "SyntheticSequences", ShortSequences)
    evals = {}
    try:
        solver = solver_runner.main(argv)
        for slots in ("8", "1"):
            out = io.StringIO()
            with contextlib.redirect_stdout(out):
                res = run_end_task_eval.main(argv + ["--disable-dataloader", "--tracker-slots",
                                                     slots])
            evals[slots] = (res, out.getvalue())
    finally:
        mp.undo()
    return dict(tmp=tmp, argv=argv, pretrain=pretrain, solver=solver, evals=evals,
                encoders=encoders)


def test_the_solver_maps_the_backbone_and_restores_the_encoder(runs):
    s = runs["solver"]
    assert s.cfg.backbone == "ResNet18SiamFCDilated" and s.cfg.task == "tracking"
    assert s.state.decoder.exemplar_decoder.weight.shape == (256, 512, 1, 1)
    first = runs["encoders"][0]  # the run's encoder before any step
    assert set(first) <= set(runs["pretrain"])
    assert all(torch.equal(v, runs["pretrain"][k]) for k, v in first.items())


def test_one_iteration_and_the_exact_val_pass(runs):
    s = runs["solver"]
    assert s.state.step == 1
    for k in ("siam_tracking_loss", "total_loss"):
        assert np.isfinite(s.loss_meters[k].value), k
    assert set(s.metric_meters) >= {"dist", "center_dist", "mean_iou"}
    assert (s.last_val_samples, s.last_val_batches) == (8 * VAL_PAIRS_PER_SEQ, 4)
    assert os.path.exists(os.path.join(runs["tmp"], "run", "EndTaskTrackingModel",
                                       "checkpoints_cpu", "1", "state.pt"))


@pytest.mark.parametrize("slots", ["8", "1"], ids=["batched", "serial"])
def test_run_end_task_eval_prints_the_otb_dict(runs, slots):
    """The eval restores the run's state and prints ``EVAL_RESULT``: the
    synthetic fallback's OTB dict, equal to ``run_eval``'s and to the saved
    results file under the log directory."""
    res, out = runs["evals"][slots]
    assert "Restored end-task step 1" in out and "SYNTHETIC smoke fallback" in out
    assert sorted(res) == ["num_sequences", "precision", "speed_fps", "success", "synthetic"]
    assert res["synthetic"] is True and res["num_sequences"] == 3
    assert 0.0 <= res["precision"] <= 1.0 and 0.0 <= res["success"] <= 1.0
    line = [x for x in out.splitlines() if x.startswith("EVAL_RESULT ")]
    assert len(line) == 1
    assert json.loads(line[0][len("EVAL_RESULT "):]) == {k: float(v) for k, v in res.items()}
    path = os.path.join(runs["tmp"], "run", "EndTaskTrackingModel", "results", "OTB2015",
                        "SiamFC_EndTaskTrackingModel_cpu.json")
    with open(path) as f:
        assert json.load(f)["overall"]["num_sequences"] == 3
    # the eval's encoder is the run's: frozen, the pretraining's
    assert all(torch.equal(v, runs["encoders"][-1][k]) for k, v in runs["encoders"][0].items())


def test_a_backbone_without_a_dilated_variant_is_refused(runs):
    argv = list(runs["argv"]) + ["--disable-dataloader", "--no-restore"]
    argv[argv.index("--backbone") + 1] = "ResNet34"
    with pytest.raises(ValueError, match="stride-8 dilated backbone"):
        EndTaskTrackingSolver(arg_parser.parse_args(argv))
