"""The port's frame-retrieval probe (``vince_tpu_torch/tools/eval_retrieval.py``)
against ``tools/eval_retrieval.py``: with both tools' solvers replaced by one
that embeds each frame by a fixed numpy projection of its pixels, the same
frames (each package's texture videos of the val split, centre-cropped,
embedded in padded batches) give the same scores and the same result dict.
Then the contract of ``tests/test_eval_retrieval.py`` on the port's own
solver with random weights (N = 6 videos of F = 3 frames: chance 2/17,
``restored_step`` 0), and ``restored_step`` of a checkpoint that the port's
conversion tool wrote at step 5."""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tools.eval_retrieval as jax_tool
import vince_tpu.solvers.vince_solver as jax_solver_module
import vince_tpu_torch.solvers.vince_solver as port_solver_module
from torch_port_threads import one_intra_op_thread  # noqa: F401  (a module fixture)
from vince_tpu_torch.models.vince_model import VinceEncoder
from vince_tpu_torch.tools import convert_reference_checkpoint
from vince_tpu_torch.tools import eval_retrieval as port_tool
from vince_tpu_torch.utils.torch_convert import export_vince_state_dict

SIZE = 32


def _argv(tmp, *extra):
    return ["--title", "evalret_t", "--description", "r", "--solver", "VinceSolver",
            "--dataset", "SyntheticTextureVideoDataset", "--backbone", "ResNet18",
            "--vince-embedding-size", "32", "--vince-queue-size", "256",
            "--input-width", str(SIZE), "--input-height", str(SIZE), "--num-frames", "2",
            "--use-videos", "--inter-batch-comparison", "--batch-size", "4",
            "--base-logdir", str(tmp / "logs"), "--mesh-data-size", "1",
            "--mesh-queue-size", "1", "--retrieval-videos", "6", "--retrieval-frames", "3",
            *extra]


PROJECTION = np.random.RandomState(0).randn(SIZE * SIZE * 3, 8).astype(np.float32)


def _project(images):
    return np.asarray(images, np.float32).reshape(len(images), -1) / 255.0 @ PROJECTION


class _JaxProjectionSolver:
    def __init__(self, args):
        self.state = types.SimpleNamespace(step=jnp.asarray(0))

    def embed_fn(self, state, images):
        return jnp.asarray(_project(images)), None


class _PortProjectionSolver:
    device = torch.device("cpu")

    def __init__(self, args):
        self.state = types.SimpleNamespace(step=0)

    def embed_fn(self, state, images):
        return torch.from_numpy(_project(images.numpy())), None

    def end(self):
        pass


def test_scores_equal_the_jax_tool_on_the_same_embeddings(tmp_path, monkeypatch):
    monkeypatch.setattr(jax_solver_module, "VinceSolver", _JaxProjectionSolver)
    monkeypatch.setattr(port_solver_module, "VinceSolver", _PortProjectionSolver)
    ref = jax_tool.main(_argv(tmp_path, "--no-restore"))
    got = port_tool.main(_argv(tmp_path, "--no-restore", "--platform", "cpu"))
    assert got == ref
    assert 0.0 < got["retrieval_at_1"] <= 1.0


def test_random_init_contract(tmp_path):
    result = port_tool.main(_argv(tmp_path, "--no-restore", "--platform", "cpu"))
    assert 0.0 <= result["retrieval_at_1"] <= 1.0
    # chance = (F-1)/(N*F-1) for leave-one-out over N*F frames
    assert abs(result["chance"] - 2 / 17) < 1e-4  # the dict rounds to 4 decimals
    assert result["restored_step"] == 0  # --no-restore: the random-init baseline
    assert result["num_videos"] == 6 and result["frames"] == 3


def test_restored_step_is_the_checkpoint_step(tmp_path):
    pt = tmp_path / "weights.pt"
    encoder = VinceEncoder("ResNet18", 32)
    encoder.reset_parameters(torch.Generator().manual_seed(1))
    torch.save(export_vince_state_dict(encoder.state_dict()), pt)
    ckpt = tmp_path / "converted"
    convert_reference_checkpoint.main([
        "--torch-checkpoint", str(pt), "--output-dir", str(ckpt), "--embed-size", "32",
        "--queue-size", "256", "--image-size", str(SIZE), "--step", "5"])
    result = port_tool.main(_argv(tmp_path, "--checkpoint-dir", str(ckpt), "--platform", "cpu"))
    assert result["restored_step"] == 5
    assert 0.0 <= result["retrieval_at_1"] <= 1.0


@pytest.mark.parametrize("frames", [1, 3])
def test_retrieval_at_1_is_the_leave_one_out_nearest_neighbour(frames):
    """Rows of one group are near copies: every nearest neighbour is in its
    group (1.0), unless a group has no other member (0.0)."""
    rng = np.random.RandomState(2)
    centres = rng.randn(5, 8)
    rows = np.repeat(centres, frames, axis=0) + 1e-3 * rng.randn(5 * frames, 8)
    assert port_tool.retrieval_at_1(rows, frames) == (1.0 if frames > 1 else 0.0)
