"""The reference's released-checkpoint pipeline through the port, as
``tests/test_released_weight_pipeline.py`` runs it through ``vince_tpu``: a
reference-format torch state dict written by the test (a ResNet18 under the
``feature_extractor.module.model.`` DataParallel prefixes and the
``embedding.{0,2}`` projection, seeded values; nothing is downloaded)
→ ``vince_tpu_torch/tools/convert_reference_checkpoint.py`` → the port's
``VinceSolver`` restoring it through ``--checkpoint-dir`` → embeddings equal
(1e-4) to those of JAX's ``VinceSolver`` started from the same file with
``--pretrained-weights-path``, and to the torch forward of the written
model. Beside it: ``export_reference_checkpoint.py`` gives the written dict
back bit for bit (its ``num_batches_tracked`` are written as 0, as the
export writes them), and the port's ``VinceSolver`` started with
``--pretrained-weights-path`` equals JAX's, key encoder included, with a
fresh queue and optimizer."""

import jax
import numpy as np
import pytest
import torch
import torch.nn as tnn

from torch_port_threads import one_intra_op_thread  # noqa: F401  (a module fixture)
from tests.test_torch_forward_parity import TorchResNet18Features
from vince_tpu.arg_parser import build_parser as jax_build_parser
from vince_tpu.arg_parser import finalize_args as jax_finalize_args
from vince_tpu.constants import IMAGENET_MEAN, IMAGENET_STD
from vince_tpu.models.vince_model import merge_params, split_vince_params
from vince_tpu.solvers.vince_solver import VinceSolver as JaxVinceSolver
from vince_tpu_torch import arg_parser
from vince_tpu_torch.solvers.vince_solver import VinceSolver
from vince_tpu_torch.solvers.vince_step import init_vince_state
from vince_tpu_torch.tools import convert_reference_checkpoint, export_reference_checkpoint
from vince_tpu_torch.utils.jax_weights import flax_to_state_dict

PREFIX = "feature_extractor.module.model."


def _argv(tmp, *extra):
    return ["--title", "wp", "--description", "conv", "--solver", "VinceSolver",
            "--dataset", "SyntheticVideoDataset", "--use-videos", "--inter-batch-comparison",
            "--num-frames", "2", "--batch-size", "16", "--input-width", "64",
            "--input-height", "64", "--vince-queue-size", "64", "--vince-embedding-size", "64",
            "--iterations-per-epoch", "2", "--epochs", "1", "--base-lr", "0.03",
            "--base-logdir", str(tmp), "--num-workers", "1", "--compute-dtype", "float32",
            "--mesh-data-size", "1", "--disable-dataloader", "--debug", *extra]


def _images(n=16, size=64, seed=9):
    return np.random.RandomState(seed).randint(0, 256, (n, size, size, 3), np.uint8)


@pytest.fixture(scope="module")
def pipeline(tmp_path_factory, cpu_devices):
    """The written file, the torch forward's embeddings, the port's solver
    restored from the converted directory, the port's and JAX's solvers
    started with ``--pretrained-weights-path``."""
    tmp = tmp_path_factory.mktemp("reference")
    torch.manual_seed(3)
    backbone = TorchResNet18Features()
    with torch.no_grad():  # non-trivial running statistics
        backbone.train()(torch.randn(8, 3, 64, 64) * 2 + 0.5)
    backbone.eval()
    embedding = tnn.Sequential(tnn.Linear(512, 512), tnn.ReLU(), tnn.Linear(512, 64)).eval()
    sd = {PREFIX + k: (torch.zeros_like(v) if k.endswith("num_batches_tracked") else v)
          for k, v in backbone.state_dict().items()}
    sd.update({"embedding." + k: v for k, v in embedding.state_dict().items()})
    pt = tmp / "vince_weights_resnet18.pt"
    torch.save(sd, pt)

    imgs = _images()
    x = torch.from_numpy(imgs.astype(np.float32) / 255.0)
    x = ((x - torch.tensor(IMAGENET_MEAN)) / torch.tensor(IMAGENET_STD)).permute(0, 3, 1, 2)
    with torch.no_grad():
        proj = embedding(backbone(x).mean(dim=(2, 3)))
    torch_emb = (proj / proj.norm(dim=1, keepdim=True).clamp_min(1e-12)).numpy()

    conv_dir = tmp / "converted"
    convert_reference_checkpoint.main([
        "--torch-checkpoint", str(pt), "--output-dir", str(conv_dir), "--backbone", "ResNet18",
        "--embed-size", "64", "--queue-size", "64", "--image-size", "64"])
    out = dict(sd=sd, pt=pt, conv_dir=conv_dir, imgs=imgs, torch_emb=torch_emb, tmp=tmp)
    solvers = []
    try:
        restored = VinceSolver(arg_parser.parse_args(
            _argv(tmp, "--checkpoint-dir", str(conv_dir), "--platform", "cpu")))
        solvers.append(restored)
        out["restored_step"] = restored.state.step
        out["restored_emb"] = restored.embed_fn(restored.state, torch.from_numpy(imgs))[0].numpy()
        out["restored_state"] = (restored.state.model.state_dict(),
                                 restored.state.key_model.state_dict())
        started = VinceSolver(arg_parser.parse_args(
            _argv(tmp / "port", "--pretrained-weights-path", str(pt), "--platform", "cpu")))
        solvers.append(started)
        out["port"] = started.state
        out["fresh_queue"] = init_vince_state(started.seed, started.cfg, started.optimizer,
                                              device="cpu").queue.vectors
        out["port_emb"] = started.embed_fn(started.state, torch.from_numpy(imgs))[0].numpy()
        jax_solver = JaxVinceSolver(jax_finalize_args(jax_build_parser().parse_args(
            _argv(tmp / "jax", "--pretrained-weights-path", str(pt)))))
        solvers.append(jax_solver)
        s = jax_solver.state
        out["jax"] = {k: jax.tree_util.tree_map(np.asarray, getattr(s, k))
                      for k in ("params", "batch_stats", "key_params", "key_batch_stats", "step")}
        out["jax_emb"] = np.asarray(jax_solver.embed_fn(s, imgs)[0])
    finally:
        for solver in solvers:
            solver.end()
    return out


def test_converted_checkpoint_restores_to_jax_embeddings(pipeline):
    assert pipeline["restored_step"] == 0
    np.testing.assert_allclose(pipeline["restored_emb"], pipeline["jax_emb"], atol=1e-4)
    np.testing.assert_allclose(pipeline["restored_emb"], pipeline["torch_emb"], atol=1e-4)
    # the converted directory and --pretrained-weights-path give one encoder
    model, key_model = pipeline["restored_state"]
    for name, v in pipeline["port"].model.state_dict().items():
        assert torch.equal(model[name], v) and torch.equal(key_model[name], v), name


@pytest.mark.parametrize("encoder", ["query", "key"])
def test_export_gives_back_the_written_dict(pipeline, encoder):
    out = pipeline["tmp"] / f"exported_{encoder}.pt"
    export_reference_checkpoint.main(["--checkpoint-dir", str(pipeline["conv_dir"]),
                                      "--output", str(out), "--encoder", encoder])
    got, ref = torch.load(out, weights_only=True), pipeline["sd"]
    assert sorted(got) == sorted(ref)
    for k, v in ref.items():
        assert got[k].dtype == v.dtype and torch.equal(got[k], v), k


def test_pretrained_weights_path_equals_jax_solver(pipeline):
    port, ref = pipeline["port"], pipeline["jax"]
    query = flax_to_state_dict(ref["params"], ref["batch_stats"])
    _, rest = split_vince_params(ref["params"])
    key = flax_to_state_dict(merge_params(ref["key_params"], rest), ref["key_batch_stats"])
    for got, want in ((port.model.state_dict(), query), (port.key_model.state_dict(), key)):
        assert sorted(got) == sorted(want)
        for name, v in want.items():
            assert np.array_equal(got[name].numpy(), v), name
    assert port.step == int(ref["step"]) == 0
    np.testing.assert_allclose(pipeline["port_emb"], pipeline["jax_emb"], atol=1e-4)
    # the queue and the optimizer's traces are those of a fresh state
    assert torch.equal(port.queue.vectors, pipeline["fresh_queue"])
    assert port.queue.inserted == 0
    assert all(not bool(t["momentum_buffer"].any()) for t in port.optimizer.state.values())
