"""The port's training CLI end to end on the CPU (``solver_runner.main``):
``--test-first``, saves at the epoch boundaries, a finished run that trains
nothing more, a resume when ``--epochs`` grows, and a crash that saves and
exits 1. Beside it: the prefill's draws per call, the jigsaw warm-up's
both-sides step, the remat and reference-weight flags, the multi-GPU flags on one process, and the end-task solvers it
builds."""

import json
import os

import numpy as np
import pytest
import torch

from torch_port_threads import one_intra_op_thread  # noqa: F401  (a module fixture)
from vince_tpu_torch import arg_parser
from vince_tpu_torch import solver_runner
from vince_tpu_torch.parallel import multihost
from vince_tpu_torch.solvers.vince_solver import VinceSolver


def _argv(tmp, *extra):
    return ["--title", "run", "--description", "cpu", "--solver", "VinceSolver",
            "--dataset", "SyntheticTextureVideoDataset", "--use-videos",
            "--inter-batch-comparison", "--num-frames", "2", "--batch-size", "4",
            "--input-width", "32", "--input-height", "32", "--vince-queue-size", "32",
            "--vince-embedding-size", "16", "--iterations-per-epoch", "2",
            "--save-frequency", "2", "--base-lr", "0.03", "--num-workers", "1",
            "--synthetic-num-videos", "8", "--platform", "cpu", "--debug",
            "--base-logdir", str(tmp), *extra]


def _steps(tmp):
    d = os.path.join(tmp, "run", "checkpoints_cpu")
    return sorted(int(n) for n in os.listdir(d) if n.isdigit())


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Four runs of ``main`` on one log directory, each one's printed lines,
    returned solver (or exit code) and checkpoint steps after it."""
    tmp = tmp_path_factory.mktemp("runner")
    out = {}
    mp = pytest.MonkeyPatch()
    try:
        for name, extra in (("first", ["--epochs", "1", "--test-first"]),
                            ("resume", ["--epochs", "2"]),
                            ("finished", ["--epochs", "2"])):
            solver = solver_runner.main(_argv(tmp, *extra))
            out[name] = dict(step=solver.state.step, epoch=solver.epoch,
                             val_batches=getattr(solver, "last_val_batches", None),
                             saved=_steps(tmp), lr=float(solver.state.optimizer.lr))
        original = VinceSolver.run_train_iteration
        calls = []

        def crash_after_one(self):
            if calls:
                raise RuntimeError("a crash in the second iteration")
            calls.append(1)
            return original(self)

        mp.setattr(VinceSolver, "run_train_iteration", crash_after_one)
        with pytest.raises(SystemExit) as exc:
            solver_runner.main(_argv(tmp, "--epochs", "3"))
        out["crash"] = dict(code=exc.value.code, saved=_steps(tmp))
    finally:
        mp.undo()
    return out


def test_first_run_validates_first_and_saves_at_the_epoch_end(runs):
    r = runs["first"]
    assert (r["step"], r["epoch"], r["val_batches"]) == (2, 1, 4)  # 8 videos, 2 a batch
    assert r["saved"] == [2]


def test_raising_epochs_resumes(runs):
    r = runs["resume"]
    assert (r["step"], r["epoch"], r["saved"]) == (4, 2, [2, 4])
    assert r["lr"] > 0


def test_a_finished_run_trains_nothing_more(runs):
    assert (runs["finished"]["step"], runs["finished"]["epoch"]) == (4, 2)
    assert runs["finished"]["saved"] == [2, 4]


def test_a_crash_saves_and_exits_1(runs):
    assert runs["crash"]["code"] == 1
    assert runs["crash"]["saved"] == [2, 4, 5]  # one step past the restored 4


def test_test_first_prints_its_val_before_training(tmp_path, capsys):
    solver_runner.main(_argv(tmp_path, "--epochs", "1", "--iterations-per-epoch", "1",
                             "--test-first", "--no-save"))
    lines = capsys.readouterr().out.splitlines()
    order = [i for i, line in enumerate(lines) if line.startswith(
        ("Running initial Val", "Running Train epoch 0", "Running Val"))]
    assert [lines[i].split(" 0")[0] for i in order] == [
        "Running initial Val", "Running Train epoch", "Running Val"]
    assert not os.path.exists(tmp_path / "run" / "checkpoints_cpu")


@pytest.fixture(scope="module")
def solver(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("prefill")
    s = VinceSolver(arg_parser.parse_args(_argv(tmp, "--no-restore", "--no-batch-prefetch")))
    yield s
    s.end()


def test_prefill_draws_anew_per_call_and_repeats_from_the_same_count(solver):
    batch, _ = solver.get_batch()
    solver._prefill_counter = 0
    first, src = solver._embed_batch_keys(batch)
    second, _ = solver._embed_batch_keys(batch)
    solver._prefill_counter = 0
    again, _ = solver._embed_batch_keys(batch)
    assert first.shape == (4, 16) and torch.equal(src, torch.ones(4, dtype=torch.int32))
    assert not torch.allclose(first, second)
    assert torch.equal(first, again)
    assert solver._prefill_counter == 1


def test_fill_queue_repeat_writes_the_queue_in_place(solver):
    q = solver.state.queue
    ptrs = (q.vectors.data_ptr(), q.sources.data_ptr(), q.tail.data_ptr(), q.total.data_ptr())
    q.tail.fill_(3)
    solver.fill_queue_repeat()
    assert ptrs == (q.vectors.data_ptr(), q.sources.data_ptr(), q.tail.data_ptr(),
                    q.total.data_ptr())
    assert (int(q.tail), int(q.total), q.inserted) == (0, 0, 0)
    np.testing.assert_array_equal(q.vectors[:4].numpy(), q.vectors[4:8].numpy())
    assert solver.image_ring.tail == 0


def test_fill_queue_fills_the_bank_from_distinct_batches(solver):
    q = solver.state.queue
    ptr = q.vectors.data_ptr()
    solver.fill_queue()  # 32 rows from 8 batches of 4 keys
    assert (int(q.tail), int(q.total), q.inserted, q.full) == (0, 32, 32, True)
    assert q.vectors.data_ptr() == ptr
    assert not torch.allclose(q.vectors[:4], q.vectors[4:8])  # not one batch repeated
    assert torch.allclose(q.vectors.norm(dim=-1), torch.ones(32), atol=1e-4)
    assert all(im is not None for im in solver.image_ring.images)


@pytest.mark.parametrize("sides", ["alternate", "both"])
def test_jigsaw_warmup_builds_the_both_sides_step(tmp_path, sides):
    """With warm-up steps the both-sides step exists for either ``sides``
    (``both`` with warm-up steps passes no parser: a caller sets it), so the
    warm-up finds its step."""
    args = arg_parser.parse_args(_argv(tmp_path, "--jigsaw", "--jigsaw-warmup-steps", "2",
                                       "--no-restore", "--disable-dataloader"))
    args.jigsaw_sides = sides
    s = VinceSolver(args)
    try:
        assert s.select_step() is s.train_step_jigsaw_both
        if sides == "both":
            assert s.train_step_jigsaw_both is s.train_step_jigsaw_q is s.train_step_jigsaw_k
        s.iteration = 2 * args.batch_size  # past the warm-up: the coin
        assert s.select_step() in (s.train_step_jigsaw_q, s.train_step_jigsaw_k)
    finally:
        s.end()


@pytest.mark.parametrize("flag", ["--remat", "--pretrained-weights-path",
                                  "--use-imagenet-weights"])
def test_ported_flags_build_what_jax_builds(tmp_path, flag):
    """``--remat`` reaches the step's config and both encoders' backbones;
    ``--pretrained-weights-path`` loads the file's weights into the query
    encoder and the key encoder copies them; ``--use-imagenet-weights``
    without a path that exists loads nothing (JAX loads a file only if it
    exists). The end-task solvers take each flag and ignore it, as JAX's do."""
    from vince_tpu_torch.models.vince_model import VinceEncoder
    from vince_tpu_torch.solvers.vince_step import init_vince_state
    from vince_tpu_torch.utils.torch_convert import (
        convert_vince_state_dict, export_vince_state_dict)

    extra = [flag]
    if flag == "--pretrained-weights-path":
        encoder = VinceEncoder("ResNet18", 16)
        encoder.reset_parameters(torch.Generator().manual_seed(1))
        torch.save(export_vince_state_dict(encoder.state_dict()), tmp_path / "w.pt")
        extra.append(str(tmp_path / "w.pt"))
    argv = _argv(tmp_path, "--disable-dataloader", "--no-restore", *extra)
    solver = VinceSolver(arg_parser.parse_args(argv))
    try:
        state = solver.state
        assert solver.cfg.remat == (flag == "--remat")
        assert state.model.backbone.remat == state.key_model.backbone.remat == solver.cfg.remat
        if flag == "--pretrained-weights-path":
            want = convert_vince_state_dict(torch.load(tmp_path / "w.pt", weights_only=True))
        else:
            want = init_vince_state(0, solver.cfg, solver.optimizer,
                                    device="cpu").model.state_dict()
        for model in (state.model, state.key_model):
            got = model.state_dict()
            assert sorted(got) == sorted(want)
            assert all(torch.equal(got[k], v) for k, v in want.items())
    finally:
        solver.end()
    argv[argv.index("--solver") + 1] = "EndTaskImagenetSolver"
    end_task = solver_runner.get_solver_class("EndTaskImagenetSolver")(
        arg_parser.parse_args(argv))
    end_task.end()


@pytest.mark.parametrize("extra", [
    ["--mesh-data-size", "2"], ["--pytorch-gpu-ids", "0,1"], ["--distributed"], ["--sync-bn"],
    ["--shuffle-mode", "a2a"]], ids=lambda extra: extra[0])
def test_multi_gpu_flags_build_the_jax_config(tmp_path, monkeypatch, capsys, extra):
    """The flags of a multi-GPU run, on one process: a data axis of 2 is
    clamped to the one process present, as JAX clamps it to the devices;
    ``--distributed`` without a group to join raises
    ``multihost.initialize``'s error for partial flags; ``--sync-bn`` and
    ``--shuffle-mode a2a`` reach the step's config."""
    args = arg_parser.parse_args(_argv(tmp_path, "--disable-dataloader", "--no-restore", *extra))
    if extra == ["--distributed"]:
        for name in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
            monkeypatch.delenv(name, raising=False)
        with pytest.raises(ValueError, match="manual clusters need all three of "
                                             "--coordinator-address, --num-processes"):
            multihost.initialize(args)
        return
    solver = VinceSolver(args)
    try:
        cfg = solver.cfg
        assert solver.mesh is None and (cfg.data_axis_size, cfg.queue_axis_size) == (1, 1)
        if extra[0] in ("--mesh-data-size", "--pytorch-gpu-ids"):
            assert "--mesh-data-size 2 clamped to 1" in capsys.readouterr().out
        assert cfg.sync_bn == (extra == ["--sync-bn"])
        assert cfg.shuffle_mode == ("a2a" if extra[0] == "--shuffle-mode" else "gather")
    finally:
        solver.end()


def test_end_task_solvers_and_a_missing_gpu_are_refused(tmp_path):
    """The four end-task solvers build (tracking maps the ResNet18 to its
    dilated variant), and without ``--platform cpu`` every solver raises when
    no GPU is present."""
    end_tasks = ("EndTaskImagenetSolver", "EndTaskSunSceneSolver", "EndTaskKinetics400Solver",
                 "EndTaskTrackingSolver")
    argv = _argv(tmp_path, "--disable-dataloader", "--no-restore")
    for name in end_tasks:
        argv[argv.index("--solver") + 1] = name
        cls = solver_runner.get_solver_class(name)
        solver = cls(arg_parser.parse_args(argv))
        try:
            assert type(solver).__name__ == name and solver.state.step == 0
            if name == "EndTaskTrackingSolver":
                assert solver.cfg.backbone == "ResNet18SiamFCDilated"
        finally:
            solver.end()
    i = argv.index("--platform")
    for name in ("VinceSolver",) + end_tasks:
        argv[argv.index("--solver") + 1] = name
        args = arg_parser.parse_args(argv[:i] + argv[i + 2:])
        assert args.platform == "cuda"
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="no CUDA device"):
                solver_runner.get_solver_class(name)(args)


def test_profile_dir_traces_global_steps_5_to_8(tmp_path):
    """The trace of steps 5-8 holds the port's spans (tracing on from the
    solver's start); the tracing records beside it hold set-up's and every
    iteration's; tracing is off once they are written."""
    from vince_tpu_torch.utils import tracing

    solver = solver_runner.main(_argv(tmp_path, "--epochs", "1", "--iterations-per-epoch", "9",
                                      "--no-save", "--profile-dir", str(tmp_path / "trace")))
    assert solver._trace_done and solver._profiler is None
    assert sorted(os.listdir(tmp_path / "trace")) == ["trace_steps_5-8.json",
                                                      "vince_records.json"]
    assert os.path.getsize(tmp_path / "trace" / "trace_steps_5-8.json") > 1000
    with open(tmp_path / "trace" / "trace_steps_5-8.json") as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"vince.iter.data_wait", "vince.iter.step", "vince.iter.metrics",
            "vince.iter.log_save", "vince.step.draws", "vince.step.body"} <= names
    with open(tmp_path / "trace" / "vince_records.json") as f:
        spans = json.load(f)["spans"]
    assert len(spans["vince.iter.step"]) == 8  # the records are written before step 8
    assert len(spans["vince.setup.init_state"]) == 1
    assert not tracing.enabled() and tracing.records()["spans"] == {}


def test_image_panels_are_logged_where_tensorboard_writes(tmp_path, monkeypatch):
    """Without ``--debug`` and with tensorboardX, the panels of iterations 1
    and 2 (``--image-log-frequency 1``) go to the train logger."""
    pytest.importorskip("tensorboardX")
    from vince_tpu_torch.utils.logger import Logger

    images = []
    original = Logger.image_summary

    def record(self, tag, image, step, **kw):
        images.append((tag, image.shape, image.dtype, step))
        return original(self, tag, image, step, **kw)

    monkeypatch.setattr(Logger, "image_summary", record)
    argv = [a for a in _argv(tmp_path, "--epochs", "1", "--iterations-per-epoch", "3",
                             "--image-log-frequency", "1", "--no-save") if a != "--debug"]
    solver_runner.main(argv)
    name = "VinceSolver_VinceModel"
    assert [(t, s) for t, _, _, s in images] == [
        (f"{name}_inputs/YT", 4), (f"{name}_outputs/YT", 4),
        (f"{name}_inputs/YT", 8), (f"{name}_outputs/YT", 8)]
    # the neighbour panel: 10 rows of a query and its 9 neighbours, 36x36 cells
    assert images[1][1] == (360, 360, 3) and all(d == np.uint8 for _, _, d, _ in images)
