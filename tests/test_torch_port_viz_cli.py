"""The port's three visualization CLIs (``vince_tpu_torch/visualizations/
{attention,dataset_mosaic,view_nearest_neighbors}.py``), as
``tests/test_viz_cli.py`` drives JAX's: each ``main`` writes its files from a
port pretraining checkpoint (ResNet18, 32², embeddings 16, the attention
pool). On one JAX state carried into the port (``load_jax_state``) the grids
are JAX's: ``attention_grid``'s pixels within one level, ``sample_mosaic``
bit-equal, ``pca_reduce`` sklearn's up to each column's sign (rtol 1e-4),
``nn_grid``'s neighbours (images that encode their index) equal. Without
``sklearn``, ``--with-tsne`` raises an ``ImportError`` that names it after
the mosaic is written."""

import contextlib
import io
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_threads import one_intra_op_thread  # noqa: F401  (a module fixture)
from vince_tpu.parallel.mesh import MeshSpec, make_mesh
from vince_tpu.solvers import vince_step as jvs
from vince_tpu.utils.schedules import vince_lr_schedule as jax_schedule
from vince_tpu.visualizations import attention as jattention
from vince_tpu.visualizations import dataset_mosaic as jmosaic
from vince_tpu.visualizations import view_nearest_neighbors as jnn
from vince_tpu_torch import arg_parser, solver_runner
from vince_tpu_torch.data.synthetic_dataset import SyntheticVideoDataset
from vince_tpu_torch.solvers import vince_step as tvs
from vince_tpu_torch.utils.jax_weights import load_jax_state
from vince_tpu_torch.visualizations import attention, dataset_mosaic, view_nearest_neighbors

RUN = ["--title", "viz_t", "--description", "vz", "--solver", "VinceSolver",
       "--dataset", "SyntheticVideoDataset", "--use-videos", "--inter-batch-comparison",
       "--num-frames", "2", "--batch-size", "8", "--input-width", "32", "--input-height", "32",
       "--vince-queue-size", "32", "--vince-embedding-size", "16", "--base-lr", "0.03",
       "--num-workers", "2", "--synthetic-num-videos", "16", "--use-attention",
       "--platform", "cpu"]
SOURCE = dict(name="YT", batch_size=8, num_frames=2, transform="StandardVideoTransform",
              source_id=1)
COMMON = dict(backbone="ResNet18", embed_size=16, image_size=32, queue_size=32,
              use_attention=True, bn_fold="expand")


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    """A 2-iteration port pretraining run with the attention pool, saved."""
    tmp = tmp_path_factory.mktemp("viz")
    solver_runner.main(RUN + ["--base-logdir", str(tmp), "--iterations-per-epoch", "2",
                              "--epochs", "1", "--save-frequency", "2", "--debug"])
    return tmp


def _main(module, tmp, *extra):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        written = module.main(RUN + ["--base-logdir", str(tmp), "--num-images", "6",
                                     "--output-dir", str(tmp / "viz"), *extra])
    assert "Restored step 2" in out.getvalue() or module is dataset_mosaic
    return written


def _non_empty(path):
    return path.exists() and path.stat().st_size > 0


def test_attention_cli(checkpoint):
    _main(attention, checkpoint)
    assert _non_empty(checkpoint / "viz" / "attention_vz.jpg")


def test_view_nearest_neighbors_cli(checkpoint):
    _main(view_nearest_neighbors, checkpoint)
    assert _non_empty(checkpoint / "viz" / "nn_vz.jpg")


def test_dataset_mosaic_cli(checkpoint):
    _main(dataset_mosaic, checkpoint, "--with-tsne")
    for name in ("mosaic.jpg", "tsne.jpg"):
        assert _non_empty(checkpoint / "viz" / name)


def test_with_tsne_without_sklearn_names_it(checkpoint, monkeypatch, tmp_path):
    for name in ("sklearn", "sklearn.manifold"):
        monkeypatch.setitem(sys.modules, name, None)
    with pytest.raises(ImportError, match="sklearn"):
        dataset_mosaic.main(RUN + ["--base-logdir", str(checkpoint), "--output-dir",
                                   str(tmp_path), "--with-tsne"])
    assert _non_empty(tmp_path / "mosaic.jpg")


@pytest.fixture(scope="module")
def solvers():
    """JAX's state from one key, the port's carried from it, each behind the
    ``panel_fn``/``embed_fn``/``state`` of a solver; the items of the port's
    val split."""
    cfg_j = jvs.VinceConfig(sources=(jvs.SourceSpec(**SOURCE),), compute_dtype=jnp.float32,
                            **COMMON)
    cfg_t = tvs.VinceConfig(sources=(tvs.SourceSpec(**SOURCE),), compute_dtype=torch.float32,
                            **COMMON)
    schedule = dict(base_lr=0.03, epochs=1, iterations_per_epoch=1, use_warmup=False)
    opt_j = jvs.build_vince_optimizer(jax_schedule(**schedule))
    host = jax.tree_util.tree_map(np.asarray, jax.device_get(
        jax.jit(lambda key: jvs.init_vince_state(key, cfg_j, opt_j))(jax.random.PRNGKey(0))))
    mesh = make_mesh(MeshSpec(data_axis_size=1, queue_axis_size=1))
    state_j = jvs.shard_state(jax.tree_util.tree_map(jnp.asarray, host), mesh)
    state_t = tvs.init_vince_state(0, cfg_t, tvs.build_vince_optimizer(0.03), device="cpu")
    load_jax_state(state_t, host)
    jax_solver = types.SimpleNamespace(state=state_j, panel_fn=jvs.make_panel_fn(cfg_j, mesh),
                                       embed_fn=jvs.make_embed_fn(cfg_j, mesh))
    port_solver = types.SimpleNamespace(state=state_t, panel_fn=tvs.make_panel_fn(cfg_t),
                                        embed_fn=tvs.make_embed_fn(cfg_t),
                                        device=torch.device("cpu"))
    # the items read once: a video's frames are drawn anew at each read
    dataset = SyntheticVideoDataset(arg_parser.parse_args(RUN + ["--base-logdir", "unused"]),
                                    "val", num_videos=16)
    return jax_solver, port_solver, [dataset[i] for i in range(len(dataset))]


def test_attention_grid_is_jax(solvers):
    """6 images in batches of 4 (the second padded): the overlays within one
    level of JAX's."""
    jax_solver, port_solver, dataset = solvers
    ref = jattention.attention_grid(jax_solver, dataset, 6, 4)
    got = attention.attention_grid(port_solver, dataset, 6, 4)
    assert got.shape == ref.shape and got.dtype == np.uint8
    assert np.abs(got.astype(int) - ref.astype(int)).max() <= 1


def test_embed_dataset_is_jax(solvers):
    jax_solver, port_solver, dataset = solvers
    images_j, emb_j = jnn.embed_dataset(jax_solver, dataset, 6, 4)
    images_t, emb_t = view_nearest_neighbors.embed_dataset(port_solver, dataset, 6, 4)
    np.testing.assert_array_equal(images_t, images_j)
    np.testing.assert_allclose(emb_t, emb_j, rtol=1e-4, atol=1e-5)


def test_sample_mosaic_is_jax(solvers):
    dataset = solvers[2]
    np.testing.assert_array_equal(dataset_mosaic.sample_mosaic(dataset, 4, 4),
                                  jmosaic.sample_mosaic(dataset, 4, 4))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_pca_reduce_is_sklearns_up_to_sign(dtype):
    features = np.random.RandomState(0).randn(80, 100).astype(dtype)
    ref = jnn.pca_reduce(features)
    got = view_nearest_neighbors.pca_reduce(features)
    assert got.shape == ref.shape == (80, 64) and got.dtype == ref.dtype
    signs = np.sign((got * ref).sum(axis=0))
    np.testing.assert_allclose(got * signs, ref, rtol=1e-4, atol=1e-4 * np.abs(ref).max())
    narrow = features[:, :64]
    assert view_nearest_neighbors.pca_reduce(narrow) is narrow
    for pca in (jnn.pca_reduce, view_nearest_neighbors.pca_reduce):
        with pytest.raises(ValueError):
            pca(features[:50])  # more components than samples


def test_nn_grid_neighbours_are_jax():
    """Image i is filled with 6·i: the grids are equal pixel for pixel, so
    the queries and their neighbours are."""
    n = 40
    images = np.broadcast_to((6 * np.arange(n, dtype=np.uint8))[:, None, None, None],
                             (n, 8, 8, 3)).copy()
    features = np.random.RandomState(1).randn(n, 16).astype(np.float32)
    got = view_nearest_neighbors.nn_grid(images, features)
    ref = jnn.nn_grid(images, features)
    np.testing.assert_array_equal(got, ref)
    assert len(np.unique(got[::8, ::8, 0])) > 10
