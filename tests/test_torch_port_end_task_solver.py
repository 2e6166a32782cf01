"""The port's end tasks through the training CLI on the CPU: a pretraining run
of ``solver_runner.main`` (ResNet18, 32x32, embeddings 16) leaves a
checkpoint; the probes restore its query encoder bit for bit; the SUN
fine-tune trains, saves and resumes; the val pass counts a partial last
batch exactly; ``run_end_task_eval`` prints the val pass of the saved state;
the Kinetics LSTM runs through the CLI; a missing GPU is refused (tracking:
``test_torch_port_tracking_solver.py``)."""

import json
import os

import numpy as np
import pytest
import torch

from tests.test_torch_port_runner import one_intra_op_thread  # noqa: F401
from vince_tpu_torch import arg_parser, run_end_task_eval, solver_runner
from vince_tpu_torch.data.synthetic_dataset import SyntheticImageDataset
from vince_tpu_torch.solvers.end_task_solvers import EndTaskImagenetSolver
from vince_tpu_torch.utils.checkpoint import end_task_state_tree

BATCH = 32


@pytest.fixture(scope="module")
def pretrain(tmp_path_factory):
    """A pretraining run of two steps; its log directory and the checkpoint."""
    tmp = tmp_path_factory.mktemp("end_tasks")
    solver_runner.main([
        "--title", "run", "--description", "cpu", "--solver", "VinceSolver",
        "--dataset", "SyntheticTextureVideoDataset", "--use-videos", "--inter-batch-comparison",
        "--num-frames", "2", "--batch-size", "4", "--input-width", "32", "--input-height", "32",
        "--vince-queue-size", "32", "--vince-embedding-size", "16", "--iterations-per-epoch", "2",
        "--epochs", "1", "--save-frequency", "2", "--base-lr", "0.03", "--num-workers", "1",
        "--synthetic-num-videos", "8", "--platform", "cpu", "--debug", "--base-logdir", str(tmp)])
    path = tmp / "run" / "checkpoints_cpu" / "2" / "state.pt"
    return tmp, torch.load(path, weights_only=True)


def _argv(tmp, solver="EndTaskImagenetSolver", description="cpu", *extra):
    return ["--title", "run", "--description", description, "--solver", solver,
            "--dataset", "SyntheticImageDataset", "--batch-size", str(BATCH),
            "--input-width", "32", "--input-height", "32", "--vince-embedding-size", "16",
            "--end-task-classifier-num-classes", "4", "--iterations-per-epoch", "3",
            "--epochs", "1", "--base-lr", "0.1", "--num-workers", "1", "--save-frequency", "100",
            "--checkpoint-dir", str(tmp / "run" / "checkpoints_cpu"), "--platform", "cpu",
            "--debug", "--base-logdir", str(tmp), *extra]


def _equal(state_dict, tensors):
    return all(torch.equal(v.cpu(), tensors[k]) for k, v in state_dict.items())


def test_probe_restores_the_pretrain_query_encoder_bit_for_bit(pretrain, capsys):
    tmp, tree = pretrain
    solver = EndTaskImagenetSolver(arg_parser.parse_args(
        _argv(tmp, "EndTaskImagenetSolver", "restore", "--freeze-feature-extractor",
              "--disable-dataloader")))
    try:
        assert f"Restored pretrain encoder from {tmp / 'run' / 'checkpoints_cpu'}" in \
            capsys.readouterr().out
        encoder = solver.state.encoder.state_dict()
        assert set(encoder) == set(tree["model"])
        assert _equal(encoder, tree["model"])
        # the query encoder, not the EMA key encoder
        assert not _equal(encoder, tree["key_model"])
        assert solver.state.step == 0 and solver.iteration == 0
    finally:
        solver.end()


@pytest.fixture(scope="module")
def sun(pretrain):
    """The SUN fine-tune through ``main``: one epoch of 3 iterations, then the
    same run resumed (another 3)."""
    tmp, _ = pretrain
    first = solver_runner.main(_argv(tmp, "EndTaskSunSceneSolver", "sun"))
    ckpt_dir = tmp / "run" / "EndTaskSunSceneModel" / "checkpoints_sun"
    steps = sorted(os.listdir(ckpt_dir))
    resumed = solver_runner.main(_argv(tmp, "EndTaskSunSceneSolver", "sun"))
    return dict(first=first, steps=steps, resumed=resumed,
                steps_after=sorted(os.listdir(ckpt_dir)), ckpt_dir=ckpt_dir)


def test_sun_fine_tune_trains_the_encoder_and_saves(sun, pretrain):
    _, tree = pretrain
    assert sun["steps"] == ["3"]
    moved = [k for k, v in sun["first"].state.encoder.state_dict().items()
             if not torch.equal(v, tree["model"][k])]
    assert any(k.endswith("conv1.weight") for k in moved)
    assert any(k.endswith("running_var") for k in moved)
    assert all(np.isfinite(m.value) for m in sun["first"].loss_meters.values())


def test_sun_resume_restores_the_state_and_continues(sun):
    solver = sun["resumed"]
    saved = torch.load(sun["ckpt_dir"] / "3" / "state.pt", weights_only=True)
    assert saved["step"] == 3 and saved["optimizer"]["count"] == 3
    assert set(saved["optimizer"]) == {"count", "mu", "nu"}
    assert any(k.startswith("encoder.") for k in saved["optimizer"]["mu"])
    # iteration = step · batch_size, then three more iterations
    assert (solver.state.step, solver.iteration) == (6, 6 * BATCH)
    assert sun["steps_after"] == ["3", "6"]


def test_a_restore_is_bit_identical_to_the_files(sun, pretrain, capsys):
    tmp, _ = pretrain
    solver = solver_runner.get_solver_class("EndTaskSunSceneSolver")(arg_parser.parse_args(
        _argv(tmp, "EndTaskSunSceneSolver", "sun", "--disable-dataloader")))
    try:
        assert "Restored end-task step 6" in capsys.readouterr().out
        assert solver.iteration == 6 * BATCH
        saved = torch.load(sun["ckpt_dir"] / "6" / "state.pt", weights_only=True)
        tree = end_task_state_tree(solver.state)
        for part in ("encoder", "decoder"):
            assert _equal(tree[part], saved[part]), part
        for kind in ("mu", "nu"):
            assert _equal(tree["optimizer"][kind], saved["optimizer"][kind]), kind
        assert tree["optimizer"]["count"] == 6
    finally:
        solver.end()


@pytest.fixture(scope="module")
def probe(pretrain):
    """The frozen ImageNet probe through ``main``: 3 iterations and a save."""
    tmp, _ = pretrain
    return solver_runner.main(_argv(tmp, "EndTaskImagenetSolver", "probe",
                                    "--freeze-feature-extractor"))


def test_val_pass_counts_a_partial_last_batch_exactly(probe, pretrain):
    """50 images, 32 a batch: 2 batches, the last padded from 18 items, and
    the means over the 50 equal the per-sample metrics of one batch of all
    50 (eval-mode BatchNorm: a row's metrics do not depend on its batch)."""
    tmp, tree = pretrain
    assert _equal(probe.state.encoder.state_dict(), tree["model"])  # frozen
    ds = SyntheticImageDataset(probe.args, "val", num_images=50)
    _, loader = probe._fresh_val_loader(ds)
    try:
        res = probe.run_val(loader=loader, dataset=ds)
    finally:
        loader.shutdown()
    assert (probe.last_val_samples, probe.last_val_batches) == (50, 2)
    items = [ds[i] for i in range(50)]
    batch = {"data": torch.from_numpy(np.concatenate([it["data"] for it in items])),
             "labels": torch.from_numpy(np.concatenate([it["classifier_labels"]
                                                        for it in items]))}
    per = probe.metric_step(probe.state, batch)
    assert sorted(res) == sorted(per)
    for k, v in per.items():
        np.testing.assert_allclose(res[k], float(v.double().mean()), rtol=1e-6, err_msg=k)


def test_run_end_task_eval_prints_the_val_pass_of_the_saved_state(probe, pretrain, capsys):
    tmp, _ = pretrain
    capsys.readouterr()
    out = run_end_task_eval.main(_argv(tmp, "EndTaskImagenetSolver", "probe",
                                       "--freeze-feature-extractor", "--disable-dataloader"))
    printed = capsys.readouterr().out
    assert "Restored end-task step 3" in printed
    (line,) = [x for x in printed.splitlines() if x.startswith("EVAL_RESULT ")]
    result = json.loads(line[len("EVAL_RESULT "):])
    assert list(result) == sorted(result) == sorted(out)
    ref = probe.run_eval()
    assert probe.last_val_samples == 512
    for k in ref:
        np.testing.assert_allclose(result[k], ref[k], rtol=1e-6, err_msg=k)


def test_kinetics_lstm_through_the_cli(pretrain):
    """8 clips of 4 frames a batch, frozen encoder: the val pass covers the
    256 clips in 32 batches."""
    tmp, tree = pretrain
    argv = _argv(tmp, "EndTaskKinetics400Solver", "kinetics", "--freeze-feature-extractor",
                 "--num-frames", "4", "--iterations-per-epoch", "2")
    argv[argv.index("SyntheticImageDataset")] = "SyntheticClipDataset"
    solver = solver_runner.main(argv)
    assert solver.state.step == 2 and solver.cfg.num_frames == 4
    assert (solver.last_val_samples, solver.last_val_batches) == (256, 32)
    assert _equal(solver.state.encoder.state_dict(), tree["model"])
    assert np.isfinite(solver.loss_meters["classifier_loss_0"].value)
    assert solver.state.decoder.lstm.hidden_size == 512
    assert not solver.state.decoder.lstm.bias_ih_l0.any()


@pytest.mark.parametrize("entry", [solver_runner.main, run_end_task_eval.main])
def test_the_entry_points_run_on_the_gpu_unless_told(pretrain, entry):
    tmp, _ = pretrain
    argv = _argv(tmp, "EndTaskSunSceneSolver", "gpu", "--disable-dataloader")
    i = argv.index("--platform")
    argv = argv[:i] + argv[i + 2:]
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default runs there")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        entry(argv)
