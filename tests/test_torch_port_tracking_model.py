"""The tracking end task's models and steps, the port against the JAX package
on the CPU in float32, with weights carried by ``jax_weights``:

- the dilated ResNets' spatial features (eval and train mode, the running
  averages after a train-mode forward), rtol 1e-4: ResNet18SiamFCDilated at
  120 px (15×15 features, the tracker's exemplar size), ResNet50SiamFCDilated
  at 64 px; weights and statistics moved off their init, so that every block's
  second conv counts (its BatchNorm's scale starts at zero);
- ``SiamFCTrackingModel``'s responses and projections, rtol 1e-5 (and
  atol 1e-5 of the map's largest value: a response sums products that
  cancel);
- one tracking train step, frozen and fine-tuned, from one perturbed state on
  both sides (exemplars of 64 px, searches of 96 px, 5×5 labels): the
  metrics rtol 1e-5, the BatchNorm statistics after the exemplar and the
  search forward chained (fine-tuned), the SGD-updated tensors and the
  decoder's traces rtol 1e-4, the fine-tuned encoder's traces within 1e-2 of
  their norm (``TRACE_NORM``); the frozen encoder unchanged;
- the per-sample eval step, rtol 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_port_end_task_step import _perturbed, _snapshot
from tests.test_torch_port_runner import one_intra_op_thread  # noqa: F401
from vince_tpu.models import tracking_model as jtm
from vince_tpu.models.vince_model import VinceEncoder as JaxEncoder
from vince_tpu.parallel.mesh import MeshSpec, make_mesh
from vince_tpu.solvers import end_task_step as jet
from vince_tpu.utils.schedules import vince_lr_schedule as jax_schedule
from vince_tpu_torch.models import tracking_model as ttm
from vince_tpu_torch.models.vince_model import VinceEncoder
from vince_tpu_torch.solvers import end_task_step as tet
from vince_tpu_torch.utils.jax_weights import (
    flax_decoder_to_state_dict,
    load_jax_end_task_state,
    load_jax_variables,
)
from vince_tpu_torch.utils.schedules import vince_lr_schedule

# the solver's schedule (its count is part of the optimizer state)
SCHEDULE = dict(base_lr=0.05, epochs=4, iterations_per_epoch=1, use_warmup=False)

EMBED, RTOL, STATE_RTOL = 16, 1e-5, 1e-4
# the fine-tuned encoder's gradients (its SGD traces) through two train-mode
# forwards are f32 sums whose order matters: with the batch's rows permuted,
# JAX's move by up to 3e-3 of their norm, and the port's by up to 2.3e-3
# (``python -m tests.test_torch_port_tracking_model`` prints both)
TRACE_NORM = 1e-2


def _moved(tree, seed):
    rng = np.random.RandomState(seed)

    def move(path, x):
        x = np.asarray(x)
        if jax.tree_util.keystr(path).endswith("['var']"):
            return jnp.asarray(x * np.exp(0.2 * rng.randn(*x.shape)).astype(np.float32))
        return jnp.asarray((x + 0.2 * (float(x.std()) or 1.0) * rng.randn(*x.shape))
                           .astype(np.float32))

    return jax.tree_util.tree_map_with_path(move, tree)


@pytest.mark.parametrize("backbone,size,cells", [("ResNet18SiamFCDilated", 120, 15),
                                                 ("ResNet50SiamFCDilated", 64, 8)])
def test_dilated_backbone_features_match(backbone, size, cells):
    images = np.random.RandomState(0).rand(2, size, size, 3).astype(np.float32) - 0.5
    enc_j = JaxEncoder(backbone_name=backbone, embed_size=EMBED)
    variables = _moved(enc_j.init(jax.random.PRNGKey(0), jnp.asarray(images)), 1)
    enc_t = VinceEncoder(backbone, EMBED)
    load_jax_variables(enc_t, variables["params"], variables["batch_stats"])
    for train in (False, True):
        out_j, mut = enc_j.apply(variables, jnp.asarray(images), train=train,
                                 mutable=["batch_stats"], method=JaxEncoder.extract_features)
        enc_t.train(train)
        with torch.no_grad():
            got = enc_t.extract_features(torch.from_numpy(images))["spatial_features"].numpy()
        ref = np.asarray(out_j["spatial_features"])
        assert got.shape == ref.shape == (2, cells, cells, enc_t.output_channels)
        np.testing.assert_allclose(got, ref, rtol=STATE_RTOL, atol=1e-4 * np.abs(ref).max())
    stats = VinceEncoder(backbone, EMBED)
    load_jax_variables(stats, variables["params"], mut["batch_stats"])
    for k, v in stats.state_dict().items():
        if k.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(enc_t.state_dict()[k].numpy(), v.numpy(),
                                       rtol=STATE_RTOL, atol=1e-6, err_msg=k)


def test_siamfc_head_matches():
    rng = np.random.RandomState(2)
    zf = rng.randn(3, 6, 6, 32).astype(np.float32)
    xf = rng.randn(3, 11, 11, 32).astype(np.float32)
    head_j = jtm.SiamFCTrackingModel()
    params = _moved(head_j.init(jax.random.PRNGKey(0), jnp.asarray(zf), jnp.asarray(xf)), 3)
    head_t = ttm.SiamFCTrackingModel(32)
    head_t.load_state_dict({k: torch.tensor(v) for k, v in
                            flax_decoder_to_state_dict(params["params"]).items()})
    ref = np.asarray(head_j.apply(params, jnp.asarray(zf), jnp.asarray(xf)))
    got = head_t(torch.from_numpy(zf), torch.from_numpy(xf)).detach().numpy()
    assert got.shape == ref.shape == (3, 6, 6, 1)
    # a response is a sum of 9216 products that cancel: its error scales with the map's
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=RTOL * np.abs(ref).max())
    proj_j = head_j.apply(params, jnp.asarray(zf), jnp.asarray(xf),
                          method=jtm.SiamFCTrackingModel.project)
    proj_t = head_t.project(torch.from_numpy(zf), torch.from_numpy(xf))
    for k in ("z", "x"):
        np.testing.assert_allclose(proj_t[k].detach().numpy(), np.asarray(proj_j[k]),
                                   rtol=RTOL, atol=1e-5)


def _config(module, frozen, dtype):
    return module.EndTaskConfig(task="tracking", backbone="ResNet18SiamFCDilated",
                                embed_size=EMBED, num_classes=4, image_size=64,
                                transform="GOT10KTransform", freeze_feature_extractor=frozen,
                                compute_dtype=dtype)


def _batch(seed):
    rng = np.random.RandomState(seed)
    labels = np.zeros((4, 5, 5), np.float32)
    labels[:, 1:4, 2] = labels[:, 2, 1:4] = 1.0
    return {"exemplar": rng.randint(0, 256, (4, 64, 64, 3)).astype(np.uint8),
            "search": rng.randint(0, 256, (4, 96, 96, 3)).astype(np.uint8),
            "labels": labels}


@pytest.fixture(scope="module", params=[True, False], ids=["frozen", "finetuned"])
def step_run(request):
    frozen = request.param
    cfg_j = _config(jet, frozen, jnp.float32)
    opt_j = jet.build_optimizer(cfg_j, 0.05, "sgd", schedule=jax_schedule(**SCHEDULE))
    state_j = _perturbed(jax.jit(lambda key: jet.init_end_task_state(key, cfg_j, opt_j))(
        jax.random.PRNGKey(0)))
    mesh = make_mesh(MeshSpec(data_axis_size=1, queue_axis_size=1))
    cfg_t = _config(tet, frozen, torch.float32)
    opt_t = tet.build_optimizer(cfg_t, 0.05, "sgd", schedule=vince_lr_schedule(**SCHEDULE))

    def port_view(jax_state):
        state = tet.init_end_task_state(1, cfg_t, opt_t, device="cpu")
        load_jax_end_task_state(state, jax.tree_util.tree_map(np.asarray,
                                                              jax.device_get(jax_state)))
        return state

    state_t = port_view(state_j)
    before = _snapshot(state_t)
    batch = _batch(0)
    step_j = jet.make_end_task_train_step(cfg_j, opt_j, mesh, train=True)
    new_j, m_j = step_j(state_j, {k: jnp.asarray(v) for k, v in batch.items()},
                        jax.random.PRNGKey(1))
    state_t, m_t = tet.make_end_task_train_step(cfg_t, train=True)(
        state_t, {k: torch.from_numpy(v) for k, v in batch.items()})
    ev = _batch(1)
    per_j = jet.make_end_task_train_step(cfg_j, opt_j, mesh, train=False, per_sample=True)(
        new_j, {k: jnp.asarray(v) for k, v in ev.items()}, jax.random.PRNGKey(1))
    per_t = tet.make_end_task_train_step(cfg_t, train=False, per_sample=True)(
        port_view(new_j), {k: torch.from_numpy(v) for k, v in ev.items()})
    return dict(frozen=frozen, before=before, metrics=(m_t, m_j),
                state=(_snapshot(state_t), _snapshot(port_view(new_j))), eval=(per_t, per_j))


def test_tracking_step_metrics(step_run):
    got, ref = step_run["metrics"]
    assert sorted(got) == sorted(ref) == ["center_dist", "dist", "loss/siam_tracking_loss",
                                          "loss/total_loss", "mean_iou"]
    for k in ref:
        np.testing.assert_allclose(float(got[k]), float(ref[k]), rtol=RTOL, err_msg=k)


def test_tracking_step_state(step_run):
    """The fine-tuned encoder's statistics moved through both forwards as
    JAX chains them; parameters and traces after SGD agree; a frozen encoder
    stays bit-equal and has no buffers."""
    got, ref = step_run["state"]
    before = step_run["before"]
    assert (got["step"], got["count"]) == (ref["step"], ref["count"]) == (1, 1)
    for part in ("encoder", "decoder", "optimizer"):
        assert set(got[part]) == set(ref[part]), part
        for k in ref[part]:
            g, e = got[part][k], ref[part][k]
            if part == "optimizer" and k[0].startswith("encoder."):
                assert np.linalg.norm(g - e) <= TRACE_NORM * np.linalg.norm(e), k
            else:
                np.testing.assert_allclose(g, e, rtol=STATE_RTOL,
                                           atol=1e-4 * max(np.abs(e).max(), 1e-3),
                                           err_msg=f"{part} {k}")
    moved = [k for k in before["encoder"]
             if not np.array_equal(got["encoder"][k], before["encoder"][k])]
    if step_run["frozen"]:
        assert moved == [] and not any(k[0].startswith("encoder.") for k in got["optimizer"])
    else:
        assert any(k.endswith("running_mean") for k in moved)
        assert any(k.endswith("conv1.weight") for k in moved)


def test_tracking_eval_step_per_sample(step_run):
    got, ref = step_run["eval"]
    assert sorted(got) == sorted(ref)
    for k in ref:
        assert got[k].shape == (4,)
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]), rtol=RTOL, atol=1e-7,
                                   err_msg=k)


if __name__ == "__main__":
    # the gaps behind TRACE_NORM, printed for the fine-tuned step:
    #   JAX_PLATFORMS=cpu python -m tests.test_torch_port_tracking_model
    # JAX against itself with the batch's rows permuted, the port against
    # itself so, and the port against JAX, each over the encoder's traces as
    # ‖Δ‖ / ‖trace‖ (min and max over the tensors)
    jax.config.update("jax_platforms", "cpu")
    cfg_j, cfg_t = _config(jet, False, jnp.float32), _config(tet, False, torch.float32)
    opt_j = jet.build_optimizer(cfg_j, 0.05, "sgd", schedule=jax_schedule(**SCHEDULE))
    opt_t = tet.build_optimizer(cfg_t, 0.05, "sgd", schedule=vince_lr_schedule(**SCHEDULE))
    state_j = _perturbed(jax.jit(lambda key: jet.init_end_task_state(key, cfg_j, opt_j))(
        jax.random.PRNGKey(0)))
    host_j = jax.tree_util.tree_map(np.asarray, jax.device_get(state_j))
    step_j = jet.make_end_task_train_step(
        cfg_j, opt_j, make_mesh(MeshSpec(data_axis_size=1, queue_axis_size=1)), train=True)
    step_t = tet.make_end_task_train_step(cfg_t, train=True)
    traces = {}
    for perm in ((0, 1, 2, 3), (3, 1, 0, 2)):
        batch = {k: v[list(perm)] for k, v in _batch(0).items()}
        new_j, _ = step_j(jax.tree_util.tree_map(jnp.asarray, host_j),
                          {k: jnp.asarray(v) for k, v in batch.items()}, jax.random.PRNGKey(1))
        state_t = tet.init_end_task_state(1, cfg_t, opt_t, device="cpu")
        load_jax_end_task_state(state_t, host_j)
        state_t, _ = step_t(state_t, {k: torch.from_numpy(v) for k, v in batch.items()})
        view = tet.init_end_task_state(1, cfg_t, opt_t, device="cpu")
        load_jax_end_task_state(view, jax.tree_util.tree_map(np.asarray, jax.device_get(new_j)))
        for side, st in (("jax", view), ("port", state_t)):
            traces[side, perm] = {k: v.numpy().copy() for k, v in
                                  st.optimizer.state_tree()["trace"].items()
                                  if k.startswith("encoder.")}

    def gaps(a, b):
        r = [np.linalg.norm(a[k] - b[k]) / np.linalg.norm(b[k]) for k in b]
        return f"{min(r):.2e} to {max(r):.2e}"

    first, second = (0, 1, 2, 3), (3, 1, 0, 2)
    print("JAX against itself, rows permuted:", gaps(traces["jax", second], traces["jax", first]))
    print("port against itself, rows permuted:",
          gaps(traces["port", second], traces["port", first]))
    print("port against JAX:", gaps(traces["port", first], traces["jax", first]))
