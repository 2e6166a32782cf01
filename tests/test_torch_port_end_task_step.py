"""The end-task steps: two train steps, then the per-sample eval step, of the
port against ``vince_tpu.solvers.end_task_step.make_end_task_train_step`` on
a 1x1 mesh, for the three ported solvers' configurations: the ImageNet probe
(SGD, frozen encoder, heads at (1, 0.01)), SUN-397 (Adam, fine-tuned encoder:
its weights and BatchNorm statistics move) and Kinetics-400 (Adam, frozen,
2 clips x 4 frames through the LSTM). ResNet18 at 32x32, embeddings 16, 4
classes, float32 on the CPU; the two steps take different rates, and each
starts both sides from one state (JAX's, carried into the port by
``load_jax_end_task_state``), moved off its init (``_perturbed``).

Both sides get the same numpy-made images: ``augment_batch`` is replaced in
each side's ``end_task_step`` module by the identity."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_port_runner import one_intra_op_thread  # noqa: F401
from vince_tpu.parallel.mesh import MeshSpec, make_mesh
from vince_tpu.solvers import end_task_step as jet
from vince_tpu.utils.schedules import vince_lr_schedule as jax_schedule
from vince_tpu_torch.solvers import end_task_step as tet
from vince_tpu_torch.utils.jax_weights import load_jax_end_task_state
from vince_tpu_torch.utils.schedules import vince_lr_schedule

SIZE, EMBED, CLASSES, STEPS = 32, 16, 4, 2
CONFIGS = {
    "imagenet": dict(task="classifier", kind="sgd", frozen=True, scales=(1.0, 0.01),
                     base_lr=0.5, rows=8, frames=1),
    "sun": dict(task="classifier", kind="adam", frozen=False, scales=(1.0, 1.0),
                base_lr=1e-3, rows=8, frames=1),
    "kinetics": dict(task="kinetics", kind="adam", frozen=True, scales=(1.0, 0.01),
                     base_lr=1e-3, rows=8, frames=4),
}
# a confident sample's CE (~1e-3) is the difference of two logits ~10 wide:
# its error is absolute, ~1e-7
LOSS_RTOL, LOSS_ATOL, STATE_RTOL = 1e-5, 1e-6, 1e-4


def _schedule(base_lr):
    # cosine over 4 one-step epochs, no warm-up: the steps' rates differ
    return dict(base_lr=base_lr, epochs=4, iterations_per_epoch=1, use_warmup=False)


def _config(module, c, dtype):
    return module.EndTaskConfig(
        task=c["task"], backbone="ResNet18", embed_size=EMBED, num_classes=CLASSES,
        num_frames=c["frames"], image_size=SIZE, freeze_feature_extractor=c["frozen"],
        compute_dtype=dtype, head_lr_scales=c["scales"], bn_fold="expand")


def _snapshot(state):
    """The port state's tensors and counters, copied."""
    return dict(
        step=state.step, count=state.optimizer.count,
        encoder={k: v.detach().numpy().copy() for k, v in state.encoder.state_dict().items()},
        decoder={k: v.detach().numpy().copy() for k, v in state.decoder.state_dict().items()},
        optimizer={(n, b): t.numpy().copy() for n, s in state.optimizer.state.items()
                   for b, t in s.items()})


def _perturbed(state):
    """Every weight and statistic moved off its init by a tenth of its spread
    (of 1 for a constant leaf: the biases, BatchNorm scales and statistics),
    running variances kept positive. Some of the encoder's gradients are zero
    in exact arithmetic (a bias whose shift the next train-mode BatchNorm
    removes) and f32 noise of ~1e-8 on both sides, which Adam would scale to
    updates of ±lr; off the init, the fine-tuned encoder's weight decay gives
    each of them a true gradient of 1e-4·p."""
    rng = np.random.RandomState(3)

    def move(path, x):
        x = np.asarray(x)
        spread = float(x.std()) or 1.0
        if jax.tree_util.keystr(path).endswith("['var']"):
            return jnp.asarray(x * np.exp(0.1 * rng.randn(*x.shape)).astype(np.float32))
        return jnp.asarray((x + 0.1 * spread * rng.randn(*x.shape)).astype(np.float32))

    return state.replace(**{k: jax.tree_util.tree_map_with_path(move, getattr(state, k))
                            for k in ("encoder_params", "encoder_batch_stats", "decoder_params")})


def run(name):
    c = CONFIGS[name]
    rng = np.random.RandomState(0)
    images = [rng.rand(c["rows"], SIZE, SIZE, 3).astype(np.float32) for _ in range(STEPS + 1)]
    n_labels = c["rows"] // c["frames"]
    labels = [rng.randint(0, CLASSES, n_labels).astype(np.int32) for _ in range(STEPS + 1)]
    mp = pytest.MonkeyPatch()
    mp.setattr(jet, "augment_batch", lambda rng, images, cfg, train=True, dtype=jnp.float32,
               **kw: images.astype(dtype))
    mp.setattr(tet, "augment_batch", lambda gen, images, cfg, dtype=torch.float32, train=True,
               **kw: images.to(dtype))
    try:
        cfg_j = _config(jet, c, jnp.float32)
        opt_j = jet.build_optimizer(cfg_j, c["base_lr"], c["kind"],
                                    schedule=jax_schedule(**_schedule(c["base_lr"])))
        mesh = make_mesh(MeshSpec(data_axis_size=1, queue_axis_size=1))
        state_j = _perturbed(jax.jit(lambda key: jet.init_end_task_state(key, cfg_j, opt_j))(
            jax.random.PRNGKey(0)))
        step_j = jet.make_end_task_train_step(cfg_j, opt_j, mesh, train=True)
        eval_j = jet.make_end_task_train_step(cfg_j, opt_j, mesh, train=False, per_sample=True)

        cfg_t = _config(tet, c, torch.float32)
        opt_t = tet.build_optimizer(cfg_t, c["base_lr"], c["kind"],
                                    schedule=vince_lr_schedule(**_schedule(c["base_lr"])))

        # one port state made, each view a copy of it with the JAX state loaded
        template = tet.init_end_task_state(1, cfg_t, opt_t, device="cpu")

        def port_view(jax_state):
            state = copy.deepcopy(template)
            load_jax_end_task_state(state, jax.tree_util.tree_map(np.asarray,
                                                                  jax.device_get(jax_state)))
            return state

        step_t = tet.make_end_task_train_step(cfg_t, train=True)
        eval_t = tet.make_end_task_train_step(cfg_t, train=False, per_sample=True)
        out = dict(steps=[])
        for i in range(STEPS):
            # each step from the same state: the JAX state carried into the port
            state_t = port_view(state_j)
            before = _snapshot(state_t)
            batch = {"data": images[i], "labels": labels[i]}
            state_j, m_j = step_j(state_j, {k: jnp.asarray(v) for k, v in batch.items()},
                                  jax.random.PRNGKey(1))
            state_t, m_t = step_t(state_t, {k: torch.from_numpy(v) for k, v in batch.items()})
            out["steps"].append(dict(
                metrics=({k: float(v) for k, v in m_t.items()},
                         {k: float(v) for k, v in m_j.items()}),
                state=(_snapshot(state_t), _snapshot(port_view(state_j))), before=before))
        batch = {"data": images[STEPS], "labels": labels[STEPS]}
        per_j = eval_j(state_j, {k: jnp.asarray(v) for k, v in batch.items()},
                       jax.random.PRNGKey(1))
        per_t = eval_t(port_view(state_j), {k: torch.from_numpy(v) for k, v in batch.items()})
        out["eval"] = ({k: v.numpy() for k, v in per_t.items()},
                       {k: np.asarray(v) for k, v in per_j.items()})
        out["n_labels"] = n_labels
        return out
    finally:
        mp.undo()


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def runs(request):
    return request.param, run(request.param)


def _metrics_close(got, ref):
    assert sorted(got) == sorted(ref)
    for k in ref:
        if "accuracy" in k:
            np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
        else:
            np.testing.assert_allclose(got[k], ref[k], rtol=LOSS_RTOL, atol=LOSS_ATOL,
                                       err_msg=k)


@pytest.mark.parametrize("step", range(STEPS))
def test_step_metrics(runs, step):
    _metrics_close(*runs[1]["steps"][step]["metrics"])


@pytest.mark.parametrize("step", range(STEPS))
def test_step_state(runs, step):
    """Encoder weights and statistics, decoder, optimizer buffers and counts
    after a step from the same state. The buffers (SGD's trace, Adam's
    moments) and the statistics agree element by element, and so do the
    parameters that SGD updates. Adam's update μ̂/(√ν̂ + ε) is ±1 wherever
    |g| ≫ ε, so an element whose gradient is within f32 noise of 0 (up to
    0.15% of a conv's weights, ~1e-5 of the LSTM's input weights) takes an update that
    the noise decides: each tensor that Adam updates agrees in the norm of
    its change. A frozen encoder stays bit-equal; a fine-tuned one moves."""
    name, r = runs
    got, ref = r["steps"][step]["state"]
    before = r["steps"][step]["before"]
    adam = CONFIGS[name]["kind"] == "adam"
    assert (got["step"], got["count"]) == (ref["step"], ref["count"]) == (step + 1, step + 1)
    for part in ("encoder", "decoder", "optimizer"):
        assert set(got[part]) == set(ref[part]), part
        for k in ref[part]:
            g, e = got[part][k], ref[part][k]
            updated = adam and part != "optimizer" and not np.array_equal(e, before[part][k])
            if updated and not k.endswith(("running_mean", "running_var")):
                d_got, d_ref = g - before[part][k], e - before[part][k]
                assert np.linalg.norm(d_got - d_ref) <= 1e-2 * np.linalg.norm(d_ref), k
            else:
                np.testing.assert_allclose(g, e, rtol=STATE_RTOL, atol=1e-6,
                                           err_msg=f"{part} {k}")
    moved = [k for k in before["encoder"]
             if not np.array_equal(got["encoder"][k], before["encoder"][k])]
    if CONFIGS[name]["frozen"]:
        assert moved == [] and not any(k[0].startswith("encoder.") for k in got["optimizer"])
    else:
        assert any(k.endswith("running_mean") for k in moved)
        assert any(k.endswith("conv1.weight") for k in moved)


def test_eval_step_per_sample(runs):
    _, r = runs
    got, ref = r["eval"]
    for k in ref:
        assert got[k].shape == (r["n_labels"],), k
    _metrics_close(got, ref)
