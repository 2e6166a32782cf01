"""The port's CLI and embedding tool on JPEG files, on the CPU.

- Two training iterations of ``vince_tpu_torch.solver_runner`` (ResNet18,
  64x64 crops) on a tiny R2V2 tree written with ``cv2``, with the ``cv2``
  read and with ``--native-decode`` (its plain version on the CPU): the
  val pass's finite losses, finite weights, a checkpoint; the refusal of
  ``--native-decode --loader-processes``.
- ``vince_tpu_torch/tools/extract_embeddings.py`` against
  ``tools/extract_embeddings.py`` on the same JPEG tree with carried
  weights: the JAX tool's solver embeds with a fresh JAX state, which
  ``utils/jax_weights.load_jax_state`` carries into the port tool's solver.
  The same paths in the same order, and each row's cosine >= 0.9999
  (float32 on both sides, different convolution orders); with
  ``--native-decode`` the port's rows stay within 0.999 of its cv2 rows.
"""

import ast
import os

import cv2
import jax
import numpy as np
import pytest

import tools.extract_embeddings as jax_tool
import vince_tpu.solvers.vince_solver as jax_solver_module
import vince_tpu_torch.solvers.vince_solver as port_solver_module
from torch_port_threads import one_intra_op_thread  # noqa: F401  (a module fixture)
from vince_tpu_torch import native, solver_runner
from vince_tpu_torch.tools import extract_embeddings as port_tool
from vince_tpu_torch.utils.jax_weights import load_jax_state


def _write_tree(root, videos=4, frames=4, shape=(60, 80)):
    """R2V2's layout, train and val: smooth frames of ``shape``, a JPEG each."""
    for s, split in enumerate(("train", "val")):
        for v in range(videos):
            vid = f"{'AB'[v % 2]}vid{s}{v:07d}"
            rng = np.random.RandomState(100 * s + v)
            base = rng.randint(0, 256, (6, 8, 3), np.uint8)
            for f in range(frames):
                img = cv2.resize(np.roll(base, f, axis=1), shape[::-1],
                                 interpolation=cv2.INTER_CUBIC)
                path = os.path.join(root, split, vid[:2], f"{vid}_{f:06d}.jpg")
                os.makedirs(os.path.dirname(path), exist_ok=True)
                assert cv2.imwrite(path, img)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("r2v2")
    _write_tree(str(root))
    return root


def _cli_argv(tree, logdir, *extra):
    return ["--title", "files", "--description", "cpu", "--solver", "VinceSolver",
            "--dataset", "R2V2Dataset", "--data-path", str(tree), "--use-videos",
            "--inter-batch-comparison", "--num-frames", "2", "--batch-size", "4",
            "--backbone", "ResNet18", "--input-width", "64", "--input-height", "64",
            "--vince-queue-size", "32", "--vince-embedding-size", "16",
            "--iterations-per-epoch", "2", "--epochs", "1", "--save-frequency", "2",
            "--base-lr", "0.03", "--num-workers", "1", "--platform", "cpu", "--debug",
            "--base-logdir", str(logdir), *extra]


@pytest.mark.parametrize("decode", ["cv2", "native"])
def test_two_iterations_from_jpeg_files(tree, tmp_path, capsys, decode):
    native.reset_counts()
    extra = ["--native-decode"] if decode == "native" else []
    solver = solver_runner.main(_cli_argv(tree, tmp_path, *extra))
    out = capsys.readouterr().out
    assert solver.state.step == 2
    val = [ast.literal_eval(line[len("val: "):]) for line in out.splitlines()
           if line.startswith("val: ")]
    assert len(val) == 1 and np.isfinite(list(val[0].values())).all()
    assert np.isfinite(solver.state.model.embedding.fc2.weight.detach().numpy()).all()
    assert sorted(os.listdir(tmp_path / "files" / "checkpoints_cpu")) == ["2"]
    if decode == "native":
        assert native.counts["plain"] > 0 and native.counts["cv2_reads"] == 0
    else:
        assert native.counts["plain"] == 0


def test_native_decode_in_loader_processes_is_refused(tree, tmp_path):
    with pytest.raises(ValueError, match="ROADMAP.md §1 item 6a"):
        solver_runner.main(_cli_argv(tree, tmp_path, "--native-decode", "--loader-processes"))


def _tool_argv(tree, tmp, output, *extra):
    return ["--title", "emb", "--description", "d", "--solver", "VinceSolver",
            "--backbone", "ResNet18", "--batch-size", "4", "--input-width", "32",
            "--input-height", "32", "--vince-queue-size", "32", "--vince-embedding-size", "16",
            "--base-lr", "0.03", "--base-logdir", str(tmp / "logs"), "--mesh-data-size", "1",
            "--mesh-queue-size", "1", "--num-workers", "1", "--no-restore",
            "--input-dir", str(tree / "val"), "--output", str(tmp / output), *extra]


@pytest.fixture(scope="module")
def embeddings(tree, tmp_path_factory):
    """The JAX tool's output and its solver's state in numpy; the port tool's
    outputs, cv2 and native, on that state."""
    tmp = tmp_path_factory.mktemp("emb")
    carried = {}

    class JaxSolver(jax_solver_module.VinceSolver):
        def end(self):
            carried["state"] = jax.tree_util.tree_map(np.asarray, jax.device_get(self.state))
            super().end()

    class PortSolver(port_solver_module.VinceSolver):
        def __init__(self, args, *rest):
            super().__init__(args, *rest)
            load_jax_state(self.state, carried["state"])

    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(jax_solver_module, "VinceSolver", JaxSolver)
        mp.setattr(port_solver_module, "VinceSolver", PortSolver)
        jax_tool.decode_batch._pool = None
        jax_tool.main(_tool_argv(tree, tmp, "jax.npz"))
        port_tool.main(_tool_argv(tree, tmp, "port.npz", "--platform", "cpu"))
        port_tool.main(_tool_argv(tree, tmp, "native.npz", "--platform", "cpu",
                                  "--native-decode"))
    finally:
        mp.undo()
    return {k: np.load(tmp / f"{k}.npz") for k in ("jax", "port", "native")}


def _cosines(a, b):
    return (a * b).sum(1) / (np.linalg.norm(a, axis=1) * np.linalg.norm(b, axis=1))


def test_embeddings_equal_the_jax_tool(embeddings):
    ref, got = embeddings["jax"], embeddings["port"]
    assert list(got["paths"]) == list(ref["paths"]) == sorted(ref["paths"])
    assert got["embeddings"].shape == ref["embeddings"].shape == (16, 16)
    assert got["embeddings"].dtype == np.float32
    assert _cosines(got["embeddings"], ref["embeddings"]).min() >= 0.9999
    np.testing.assert_allclose(np.linalg.norm(got["embeddings"], axis=1), 1.0, atol=1e-3)


def test_native_decode_embeddings_agree_with_cv2(embeddings):
    cv, nat = embeddings["port"], embeddings["native"]
    assert list(nat["paths"]) == list(cv["paths"])
    assert _cosines(nat["embeddings"], cv["embeddings"]).min() >= 0.999
