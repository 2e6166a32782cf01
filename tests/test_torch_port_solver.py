"""The port's ``VinceSolver`` against ``vince_tpu``'s from one argv: ResNet18,
32x32 crops of 36x36 canvases, 4 videos x 2 frames, queue 64, embeddings
128, fused InfoNCE, one loader worker in ``repeatable`` mode, on the CPU
(the JAX solver on a 1x1 mesh).

JAX's state after its setup (weights, statistics and the prefilled queue) is
carried into the port's with ``load_jax_state``. The augmentation and the
shuffled-BN permutation are replaced on both sides, as in
``test_torch_port_step.py``: the step reads the centre crop of each canvas
and one fixed permutation. Three train iterations, then a val pass of two
batches with the CIFAR kNN probe on a small NPZ, then the jigsaw's choice of
step over eight iterations."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vince_tpu import arg_parser as jargs
from vince_tpu.solvers import vince_step as jvs
from vince_tpu.solvers.vince_solver import VinceSolver as JaxSolver
from vince_tpu_torch import arg_parser as targs
from vince_tpu_torch.solvers import vince_step as tvs
from vince_tpu_torch.solvers.vince_solver import VinceSolver
from vince_tpu_torch.utils.jax_weights import load_jax_state
from torch_port_threads import one_intra_op_thread  # noqa: F401  (a module fixture)

SIZE, CANVAS, BATCH = 32, 36, 8
OFF = (CANVAS - SIZE) // 2
ITERATIONS = 3


def _argv(tmp, side):
    return ["--title", "parity", "--description", side, "--solver", "VinceSolver",
            "--dataset", "SyntheticTextureVideoDataset", "--use-videos",
            "--inter-batch-comparison", "--num-frames", "2", "--batch-size", str(BATCH),
            "--input-width", str(SIZE), "--input-height", str(SIZE),
            "--vince-queue-size", "64", "--vince-embedding-size", "128",
            "--use-fused-infonce", "--backbone", "ResNet18", "--iterations-per-epoch", "4",
            "--epochs", "2", "--base-lr", "0.03", "--no-warmup", "--num-workers", "1",
            "--synthetic-num-videos", "16", "--save-frequency", "2",
            "--mesh-data-size", "1", "--mesh-queue-size", "1", "--platform", "cpu",
            "--debug", "--base-logdir", str(tmp / side),
            "--cifar-data-path", str(tmp / "cifar_{data_subset}.npz")]


def _write_probe(tmp):
    """40 images of 4 classes, each class a colour under noise wide enough
    that the probe misses some."""
    rng = np.random.RandomState(5)
    labels = np.arange(40) % 4
    colors = rng.randint(0, 256, (4, 3))
    data = np.clip(colors[labels][:, None, None, :] + rng.randint(-110, 111, (40, SIZE, SIZE, 3)),
                   0, 255).astype(np.uint8)
    np.savez(tmp / "cifar_train.npz", data=data, labels=labels)


def _crops_jax(cfg, batch, rng, d_idx, mode="train"):
    crop = lambda x: x[:, OFF:OFF + SIZE, OFF:OFF + SIZE].astype(jnp.float32) / 255.0  # noqa: E731
    return (jnp.concatenate([crop(b["data"]) for b in batch]),
            jnp.concatenate([crop(b["queue_data"]) for b in batch]))


def _crops_torch(cfg, batch, draws):
    crop = lambda x: x[:, OFF:OFF + SIZE, OFF:OFF + SIZE].float() / 255.0  # noqa: E731
    return (torch.cat([crop(b["data"]) for b in batch]),
            torch.cat([crop(b["queue_data"]) for b in batch]))


def _recorder(calls, name, metrics):
    def step(state, batch, seed):
        calls.append(name)
        return state, metrics
    return step


def _jigsaw_choices(solver, metrics, iterations=8):
    """The steps the solver picks over ``iterations`` iterations with the
    jigsaw on, 6 warm-up steps with the mix (global steps 3-5 are warm-up),
    each step replaced by a recorder."""
    calls = []
    solver.cfg = dataclasses.replace(solver.cfg, jigsaw=True)
    solver.args.jigsaw_warmup_steps, solver.args.jigsaw_warmup_mix = 6, True
    solver.args.save = False
    solver.train_step = _recorder(calls, "plain", metrics)
    for side in ("q", "k", "both"):
        setattr(solver, f"train_step_jigsaw_{side}", _recorder(calls, side, metrics))
    for _ in range(iterations):
        solver.run_train_iteration()
    return calls


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("solver")
    _write_probe(tmp)
    perm = np.random.RandomState(1).permutation(BATCH)
    mp = pytest.MonkeyPatch()
    mp.setattr(jvs, "_augment_sources", _crops_jax)
    mp.setattr(jvs, "make_shuffle_perm", lambda rng, n: jnp.asarray(perm))
    mp.setattr(tvs, "_augment_sources", _crops_torch)
    mp.setattr(tvs, "make_shuffle_perm", lambda gen, n: torch.from_numpy(perm))
    solvers = []
    try:
        a_j = jargs.finalize_args(jargs.build_parser().parse_args(_argv(tmp, "jax")))
        a_t = targs.finalize_args(targs.build_parser().parse_args(_argv(tmp, "torch")))
        a_j.repeatable = a_t.repeatable = True
        ref = JaxSolver(a_j)
        solvers.append(ref)
        got = VinceSolver(a_t)
        solvers.append(got)
        load_jax_state(got.state, jax.tree_util.tree_map(np.asarray, jax.device_get(ref.state)))
        out = {"iterations": []}
        for s in (ref, got):
            s.reset_epoch()
        for _ in range(ITERATIONS):
            m_j, m_t = ref.run_train_iteration(), got.run_train_iteration()
            out["iterations"].append(dict(
                metrics=({k: float(v) for k, v in m_t.items()},
                         {k: float(np.asarray(v)) for k, v in m_j.items()}),
                # the rate the port's step ran at, against optax's schedule
                lr=(float(got.state.optimizer.lr), float(ref.lr_schedule(ref.global_step - 1))),
                log_lr=(float(got.lr_schedule(got.global_step)),
                        float(ref.lr_schedule(ref.global_step))),
                counters=[(s.iteration, s.global_step, s.logger_iteration, s.epoch)
                          for s in (got, ref)],
                steps=(got.state.step, int(np.asarray(ref.state.step))),
                queue=((int(got.state.queue.tail), int(got.state.queue.total)),
                       (int(np.asarray(ref.state.queue.tail)),
                        int(np.asarray(ref.state.queue.total)))),
                ring=(got.image_ring.tail, ref.image_ring.tail)))
        got.ckpt.wait_until_finished()
        ref.ckpt.manager.wait_until_finished()
        out["saved"] = (got.ckpt.latest_step(), ref.ckpt.latest_step(),
                        sorted(got.ckpt.timings[i]["step"] for i in range(len(got.ckpt.timings))))
        out["val"] = (got.run_val(max_batches=2), ref.run_val(max_batches=2))
        out["val_batches"] = (got.last_val_batches, ref.last_val_batches)
        out["jigsaw"] = (
            _jigsaw_choices(got, {"loss/nce_loss": torch.tensor(1.0)}),
            _jigsaw_choices(ref, {"loss/nce_loss": np.float32(1.0)}))
        return out
    finally:
        for s in solvers:
            s.end()
        mp.undo()


@pytest.mark.parametrize("it", range(ITERATIONS))
def test_losses_and_metrics(runs, it):
    got, ref = runs["iterations"][it]["metrics"]
    assert got.keys() == ref.keys()
    assert all(np.isfinite(v) for v in ref.values())
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-4, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("it", range(ITERATIONS))
def test_learning_rates_and_counters(runs, it):
    r = runs["iterations"][it]
    np.testing.assert_allclose(*r["lr"], rtol=1e-6)
    np.testing.assert_allclose(*r["log_lr"], rtol=1e-6)
    assert r["counters"][0] == r["counters"][1] == ((it + 1) * BATCH, it + 1, it + 1, 0)
    assert r["steps"] == (it + 1, it + 1)
    assert r["queue"][0] == r["queue"][1] == (((it + 1) * BATCH) % 64, (it + 1) * BATCH)
    assert r["ring"][0] == r["ring"][1]


def test_saved_steps(runs):
    got_latest, ref_latest, got_saves = runs["saved"]
    assert got_latest == ref_latest == 2
    assert got_saves == [2]


def test_val_pass(runs):
    got, ref = runs["val"]
    assert runs["val_batches"] == (2, 2)
    assert got.keys() == ref.keys() and "epoch_knn_cifar" in got
    assert all(np.isfinite(v) for v in ref.values())
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-4, atol=1e-6, err_msg=k)


def test_knn_accuracy(runs):
    got, ref = runs["val"]
    assert got["epoch_knn_cifar"] == ref["epoch_knn_cifar"] > 0.25  # above chance


def test_jigsaw_choice_of_step(runs):
    got, ref = runs["jigsaw"]
    assert got == ref
    assert got[:3] == ["plain", "both", "plain"]  # global steps 3, 4, 5: warm-up with the mix
    assert set(got[3:]) <= {"q", "k"}
