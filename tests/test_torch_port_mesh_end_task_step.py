"""The port's end-task steps on a 2 x 1 mesh of gloo ranks against
``vince_tpu``'s ``shard_map`` end-task step on 2 virtual devices, for the
frozen ImageNet probe (SGD) and the fine-tuned SUN-397 step (Adam; the
encoder's BatchNorm running averages averaged over the data axis); Kinetics-400
(Adam, frozen, 2 clips of 4 frames: a clip a rank) and tracking (SGD,
fine-tuned: the statistics chained through the exemplar and the search
forwards, then averaged) are ``test_torch_port_mesh_end_task_step_video.py``,
with this file's cases and checks. ResNet18 (its dilated variant for tracking), 32², embeddings 16,
float32; a train step from JAX's state carried into the port, and the
per-sample eval rows from that state of both ranks in rank order (8 rows, 16 for SUN, whose
Adam update of an element with a gradient of 4 rows' noise would be decided
by it; 2 tracking pairs: 32² exemplars, 64² searches). The
tolerances are ``tests/test_torch_port_end_task_step.py``'s and
``tests/test_torch_port_tracking_model.py``'s; Adam's updates, which f32
noise decides where a gradient is near 0, are held in norm.

Both sides read the same numpy batches as the augmented images; that the
augmentation draws for the global rows is
``test_train_draws_are_keyed_by_global_row``."""

import concurrent.futures
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_port_end_task_step import (
    LOSS_ATOL, LOSS_RTOL, STATE_RTOL, _metrics_close, _perturbed, _snapshot)
from torch_port_ranks import RANK_TIMEOUT_S, mesh_end_task_rank, spawn
from torch_port_threads import one_intra_op_thread  # noqa: F401  (a module fixture)
from vince_tpu.parallel.mesh import MeshSpec, make_mesh
from vince_tpu.solvers import end_task_step as jet
from vince_tpu.utils.schedules import vince_lr_schedule as jax_schedule
from vince_tpu_torch.solvers import end_task_step as tet
from vince_tpu_torch.utils.checkpoint import end_task_state_tree
from vince_tpu_torch.utils.jax_weights import load_jax_end_task_state

MD, STEPS, EMBED, CLASSES = 2, 1, 16, 4
TRACE_NORM = 1e-2  # tests/test_torch_port_tracking_model.py's
CASES = {
    "imagenet": dict(cfg=dict(task="classifier", freeze_feature_extractor=True,
                              head_lr_scales=(1.0, 0.01)), kind="sgd", base_lr=0.5, rows=8),
    "sun": dict(cfg=dict(task="classifier", freeze_feature_extractor=False,
                         head_lr_scales=(1.0, 1.0)), kind="adam", base_lr=1e-3, rows=16),
    "kinetics": dict(cfg=dict(task="kinetics", freeze_feature_extractor=True, num_frames=4),
                     kind="adam", base_lr=1e-3, rows=8),
    "tracking": dict(cfg=dict(task="tracking", backbone="ResNet18SiamFCDilated", image_size=32,
                              transform="GOT10KTransform", freeze_feature_extractor=False),
                     kind="sgd", base_lr=0.05, rows=2),
}


def _schedule(base_lr):
    return dict(base_lr=base_lr, epochs=4, iterations_per_epoch=1, use_warmup=False)


def _cfg_kwargs(case, dtype):
    kw = dict(backbone="ResNet18", embed_size=EMBED, num_classes=CLASSES, image_size=32,
              compute_dtype=dtype, bn_fold="expand")
    kw.update(case["cfg"])
    return kw


def _batch(case, seed):
    rng = np.random.RandomState(seed)
    n = case["rows"]
    if case["cfg"]["task"] == "tracking":
        labels = np.zeros((n, 5, 5), np.float32)
        labels[:, 1:4, 2] = labels[:, 2, 1:4] = 1.0
        return {"exemplar": rng.randint(0, 256, (n, 32, 32, 3)).astype(np.uint8),
                "search": rng.randint(0, 256, (n, 64, 64, 3)).astype(np.uint8),
                "labels": labels}
    clips = n // case["cfg"].get("num_frames", 1)
    return {"data": rng.rand(n, 32, 32, 3).astype(np.float32),
            "labels": rng.randint(0, CLASSES, clips).astype(np.int32)}


def _port_tree(template, jax_state):
    """A JAX state as the port's ``end_task_state_tree`` (numpy)."""
    load_jax_end_task_state(template, jax.tree_util.tree_map(np.asarray,
                                                             jax.device_get(jax_state)))
    return {k: ({n: t.numpy().copy() for n, t in v.items()} if k in ("encoder", "decoder")
                else v) for k, v in end_task_state_tree(template).items()} | {
        "optimizer": _optimizer_tree(template)}


def _optimizer_tree(state):
    tree = state.optimizer.state_tree()
    return {k: (v if k == "count" else {n: t.numpy().copy() for n, t in v.items()})
            for k, v in tree.items()}


NAMES = ("imagenet", "sun")  # the video tasks: test_torch_port_mesh_end_task_step_video.py


@pytest.fixture(scope="module")
def runs(cpu_devices, tmp_path_factory):
    return run_cases(NAMES, tmp_path_factory)


def run_cases(names, tmp_path_factory):
    """JAX's step and eval rows for each case of ``names``, and the ranks'
    (started at once: they take each case from its file as JAX's side writes
    it, mapping its states rather than taking them pickled)."""
    cases = {name: CASES[name] for name in names}
    mp = pytest.MonkeyPatch()
    mp.setattr(jet, "augment_batch", lambda rng, images, cfg, train=True, dtype=jnp.float32,
               **kw: images.astype(dtype))
    mesh = make_mesh(MeshSpec(data_axis_size=MD, queue_axis_size=1))
    jax_out = {}
    folder = tmp_path_factory.mktemp("mesh_end_task")
    pool = concurrent.futures.ThreadPoolExecutor(1)
    ranks = pool.submit(spawn, mesh_end_task_rank, MD, str(folder), list(cases))
    try:
        for name, case in cases.items():
            cfg_j = jet.EndTaskConfig(data_axis_size=MD, **_cfg_kwargs(case, jnp.float32))
            opt_j = jet.build_optimizer(cfg_j, case["base_lr"], case["kind"],
                                        schedule=jax_schedule(**_schedule(case["base_lr"])))
            state_j = _perturbed(jax.jit(lambda key: jet.init_end_task_state(key, cfg_j, opt_j))(
                jax.random.PRNGKey(0)))
            cfg_t = tet.EndTaskConfig(**_cfg_kwargs(case, torch.float32))
            template = tet.init_end_task_state(
                1, cfg_t, tet.build_optimizer(cfg_t, case["base_lr"], case["kind"]), device="cpu")
            tree = _port_tree(template, state_j)
            before = _snapshot(template)
            eval_batch = _batch(case, STEPS)
            # the eval rows from the state before the step
            per_j = jet.make_end_task_train_step(cfg_j, opt_j, mesh, train=False,
                                                 per_sample=True)(
                state_j, {k: jnp.asarray(v) for k, v in eval_batch.items()},
                jax.random.PRNGKey(1))
            step_j = jet.make_end_task_train_step(cfg_j, opt_j, mesh, train=True)
            batch = _batch(case, 0)
            state_j, m_j = step_j(state_j, {k: jnp.asarray(v) for k, v in batch.items()},
                                  jax.random.PRNGKey(1))
            _port_tree(template, state_j)
            jax_out[name] = dict(
                steps=[dict(metrics={k: float(v) for k, v in m_j.items()},
                            state=_snapshot(template), before=before)],
                eval={k: np.asarray(v) for k, v in per_j.items()})
            torch.save(_tensors(dict(
                cfg=_cfg_kwargs(case, torch.float32), kind=case["kind"],
                base_lr=case["base_lr"], schedule=_schedule(case["base_lr"]), trees=[tree],
                batches=[batch], eval_tree=tree, eval_batch=eval_batch)), folder / "case.tmp")
            os.rename(folder / "case.tmp", folder / f"{name}.pt")
    except BaseException:
        (folder / "abort").touch()
        raise
    finally:
        mp.undo()
        pool.shutdown(wait=False)
    return jax_out, ranks.result(timeout=RANK_TIMEOUT_S)


def _tensors(tree):
    if isinstance(tree, np.ndarray):
        return torch.from_numpy(tree)
    if isinstance(tree, dict):
        return {k: _tensors(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tensors(v) for v in tree]
    return tree


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("step", range(STEPS))
def test_mesh_step_metrics(runs, name, step):
    check_step_metrics(runs, name, step)


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("step", range(STEPS))
def test_mesh_step_state(runs, name, step):
    check_step_state(runs, name, step)


@pytest.mark.parametrize("name", NAMES)
def test_mesh_eval_rows_in_rank_order(runs, name):
    check_eval_rows(runs, name)


def check_step_metrics(runs, name, step):
    jax_out, ranks = runs
    ref = jax_out[name]["steps"][step]["metrics"]
    for r in ranks:
        got = {k: float(v) for k, v in r[name]["steps"][step]["metrics"].items()}
        if name == "tracking":
            assert sorted(got) == sorted(ref)
            for k in ref:
                np.testing.assert_allclose(got[k], ref[k], rtol=LOSS_RTOL, err_msg=k)
        else:
            _metrics_close(got, ref)


def check_step_state(runs, name, step):
    """Both ranks hold the same state after a step, and it is JAX's: the
    buffers, the statistics (a fine-tuned encoder's averaged over the data
    axis) and SGD's parameters element by element; each tensor that Adam
    updates in the norm of its change; tracking's fine-tuned encoder's SGD
    traces in norm (``TRACE_NORM``). A frozen encoder stays bit-equal."""
    jax_out, ranks = runs
    ref_run = jax_out[name]["steps"][step]
    ref, before = ref_run["state"], ref_run["before"]
    adam = CASES[name]["kind"] == "adam"
    for r in ranks:
        got = r[name]["steps"][step]["state"]
        assert (got["step"], got["count"]) == (ref["step"], ref["count"]) == (step + 1, step + 1)
        for part in ("encoder", "decoder", "optimizer"):
            assert set(got[part]) == set(ref[part]), part
            for k in ref[part]:
                g, e = got[part][k], ref[part][k]
                updated = adam and part != "optimizer" and not np.array_equal(e, before[part][k])
                if updated and not k.endswith(("running_mean", "running_var")):
                    d_got, d_ref = g - before[part][k], e - before[part][k]
                    assert np.linalg.norm(d_got - d_ref) <= 1e-2 * np.linalg.norm(d_ref), k
                elif name == "tracking" and part == "optimizer" and k[0].startswith("encoder."):
                    assert np.linalg.norm(g - e) <= TRACE_NORM * np.linalg.norm(e), k
                else:
                    np.testing.assert_allclose(g, e, rtol=STATE_RTOL,
                                               atol=1e-4 * max(np.abs(e).max(), 1e-2),
                                               err_msg=f"{part} {k}")
        moved = [k for k in before["encoder"]
                 if not np.array_equal(got["encoder"][k], before["encoder"][k])]
        if CASES[name]["cfg"]["freeze_feature_extractor"]:
            assert moved == []
        else:
            assert any(k.endswith("running_mean") for k in moved)
    for part in ("encoder", "decoder"):
        for k, v in ranks[0][name]["steps"][step]["state"][part].items():
            np.testing.assert_array_equal(ranks[1][name]["steps"][step]["state"][part][k], v)


def check_eval_rows(runs, name):
    """The per-sample eval step: each rank's rows, no collective; rank 0's
    then rank 1's are JAX's rows of the global batch."""
    jax_out, ranks = runs
    ref = jax_out[name]["eval"]
    rows = CASES[name]["rows"] // CASES[name]["cfg"].get("num_frames", 1)
    for k in ref:
        got = np.concatenate([r[name]["eval"][k] for r in ranks])
        assert got.shape == ref[k].shape == (rows,), k
        if "accuracy" in k:
            np.testing.assert_array_equal(got, ref[k], err_msg=k)
        else:
            np.testing.assert_allclose(got, ref[k], rtol=LOSS_RTOL, atol=LOSS_ATOL, err_msg=k)


@pytest.mark.parametrize("group_size", [1, 4])
def test_train_draws_are_keyed_by_global_row(group_size):
    """``augment_batch`` on a rank's rows of a global batch (Kinetics: its
    clips) applies the global batch's draws to them: the augmentation does
    not depend on the mesh's shape."""
    from vince_tpu_torch.ops.augment import augment_batch
    from vince_tpu_torch.utils.transforms import make_config

    tcfg = make_config("StandardVideoTransform", 32)
    images = torch.from_numpy(np.random.RandomState(0).randint(0, 256, (16, 36, 36, 3))
                              .astype(np.uint8))
    full = augment_batch(torch.Generator().manual_seed(5), images, tcfg,
                         group_size=group_size)
    for d in range(MD):
        half = augment_batch(torch.Generator().manual_seed(5), images[d * 8:(d + 1) * 8], tcfg,
                             group_size=group_size, data_size=MD, data_index=d)
        torch.testing.assert_close(half, full[d * 8:(d + 1) * 8], rtol=0, atol=0)


def test_mesh_config_checked():
    """A step refuses a mesh that is not the config's data axis."""
    cfg = tet.EndTaskConfig(task="classifier")
    fake = dataclasses.make_dataclass("M", ["data_size", "queue_size"])(2, 1)
    with pytest.raises(ValueError, match="data axis is 1"):
        tet.make_end_task_train_step(cfg, mesh=fake)


def test_eval_step_draws_nothing(monkeypatch):
    """The val path of the eval step (per-sample or not) makes no draw, on
    any mesh: JAX folds the data index into a key that its val path never
    uses."""
    from vince_tpu_torch.ops import augment

    def no_draw(*args, **kwargs):
        raise AssertionError("the eval step drew augmentation parameters")

    monkeypatch.setattr(augment, "draw_augment_params", no_draw)
    cfg = tet.EndTaskConfig(task="classifier", embed_size=EMBED, num_classes=CLASSES,
                            image_size=32)
    state = tet.init_end_task_state(0, cfg, tet.build_optimizer(cfg, 0.1, "sgd"), device="cpu")
    batch = {"data": torch.randint(0, 256, (4, 36, 36, 3), dtype=torch.uint8),
             "labels": torch.zeros(4, dtype=torch.int32)}
    for per_sample in (True, False):
        out = tet.make_end_task_train_step(cfg, train=False, per_sample=per_sample)(state, batch)
        assert all(torch.isfinite(v).all() for v in out.values())
