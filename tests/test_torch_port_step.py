"""The slice: two VINCE train steps of the port against
``vince_tpu.solvers.vince_step.make_train_step_fn`` on a 1x1 mesh — ResNet50,
64x64 images, 8 frames (2 videos x 4), queue 64, embeddings 128, fused
InfoNCE and the fold kernel on, float32 on the CPU.

Both sides get the same numpy-made images and the same shuffled-BN
permutation: ``_augment_sources`` and ``make_shuffle_perm`` are replaced in
each side's ``vince_step`` module."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vince_tpu.parallel.mesh import MeshSpec, make_mesh
from vince_tpu.solvers import vince_step as jvs
from vince_tpu.utils.schedules import vince_lr_schedule as jax_schedule
from vince_tpu_torch.ops.kernels.folded_dot_kernel import affine_relu_dot_moments
from vince_tpu_torch.ops.kernels.infonce_kernel import queue_logsumexp
from vince_tpu_torch.solvers import vince_step as tvs
from vince_tpu_torch.utils.jax_weights import _find_trace, flax_to_state_dict, load_jax_state
from vince_tpu_torch.utils.schedules import vince_lr_schedule
from torch_port_threads import one_intra_op_thread  # noqa: F401  (a module fixture)

BATCH, FRAMES, SIZE, QUEUE, EMBED = 8, 4, 64, 64, 128
METRICS = ("loss/total_loss", "nce_accuracy", "softmax_weight", "cosine_sim",
           "cosine_sim_neg_max")
STEPS = 2
# cosine decay over 4 one-step epochs, no warmup: the two steps use different rates
SCHEDULE = dict(base_lr=0.03, epochs=4, iterations_per_epoch=1, use_warmup=False)


def _source():
    return dict(name="YT", batch_size=BATCH, num_frames=FRAMES,
                transform="StandardVideoTransform", source_id=1)


def _common(**backbone_options):
    return dict(embed_size=EMBED, image_size=SIZE, queue_size=QUEUE, temperature=0.07,
                momentum=0.999, shuffle_bn=True, bn_fold="expand", use_fused_infonce=True,
                **backbone_options)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def run_steps(wrappers, jax_options=None, **backbone_options):
    """Run ``STEPS`` steps of both packages from one state; per step the
    metrics, weights, statistics and queue of each side, and how often each of
    ``wrappers`` ran its plain version. ``jax_options`` are config fields of
    the JAX side only."""
    rng = np.random.RandomState(0)
    images = [(rng.randn(BATCH, SIZE, SIZE, 3).astype(np.float32),
               rng.randn(BATCH, SIZE, SIZE, 3).astype(np.float32)) for _ in range(STEPS)]
    perm = np.random.RandomState(1).permutation(BATCH)
    mp = pytest.MonkeyPatch()
    # the "batch" carries the augmented images; both steps read them back
    mp.setattr(jvs, "_augment_sources",
               lambda cfg, batch, rng, d_idx, mode="train": (batch[0]["data"],
                                                             batch[0]["queue_data"]))
    mp.setattr(jvs, "make_shuffle_perm", lambda rng, n: jnp.asarray(perm))
    mp.setattr(tvs, "_augment_sources",
               lambda cfg, batch, gen: (batch[0]["data"], batch[0]["queue_data"]))
    mp.setattr(tvs, "make_shuffle_perm", lambda gen, n: torch.from_numpy(perm))
    try:
        cfg_j = jvs.VinceConfig(sources=(jvs.SourceSpec(**_source()),),
                                compute_dtype=jnp.float32,
                                **{**_common(**backbone_options), **(jax_options or {})})
        opt_j = jvs.build_vince_optimizer(jax_schedule(**SCHEDULE))
        mesh = make_mesh(MeshSpec(data_axis_size=1, queue_axis_size=1))
        # jitted: the same state as the eager call, in a third of the time
        init_j = jax.jit(lambda key: jvs.init_vince_state(key, cfg_j, opt_j))
        state_j = jvs.shard_state(init_j(jax.random.PRNGKey(0)), mesh)
        step_j = jax.jit(jvs.make_train_step_fn(cfg_j, opt_j, mesh))

        cfg_t = tvs.VinceConfig(sources=(tvs.SourceSpec(**_source()),),
                                compute_dtype=torch.float32, **_common(**backbone_options))
        opt_t = tvs.build_vince_optimizer(vince_lr_schedule(**SCHEDULE))
        state_t = tvs.init_vince_state(0, cfg_t, opt_t, device="cpu")
        load_jax_state(state_t, jax.tree_util.tree_map(np.asarray, jax.device_get(state_j)))
        step_t = tvs.make_train_step_fn(cfg_t, opt_t)

        results = []
        init = {k: v.detach().numpy().copy() for k, v in state_t.model.state_dict().items()}
        for q_img, k_img in images:
            state_j, m_j = step_j(state_j, ({"data": jnp.asarray(q_img),
                                             "queue_data": jnp.asarray(k_img)},),
                                  jax.random.PRNGKey(1))
            before = [w.plain_calls for w in wrappers]
            state_t, m_t = step_t(state_t, ({"data": torch.from_numpy(q_img),
                                             "queue_data": torch.from_numpy(k_img)},), 0)
            calls = tuple(w.plain_calls - b for w, b in zip(wrappers, before))
            sj = jax.device_get(state_j)
            results.append(dict(
                metrics=({k: float(m_t[k]) for k in METRICS},
                         {k: float(m_j[k]) for k in METRICS}),
                params=({k: v.detach().numpy().copy() for k, v in state_t.model.state_dict().items()},
                        flax_to_state_dict(sj.params, sj.batch_stats)),
                key_params=({k: v.detach().numpy().copy()
                             for k, v in state_t.key_model.state_dict().items()},
                            flax_to_state_dict({**sj.params, **sj.key_params},
                                               sj.key_batch_stats)),
                queue=((state_t.queue.vectors.numpy().copy(), state_t.queue.sources.numpy().copy(),
                        int(state_t.queue.tail), int(state_t.queue.total)),
                       (np.asarray(sj.queue.vectors), np.asarray(sj.queue.sources),
                        int(sj.queue.tail), int(sj.queue.total))),
                momentum=({k: state_t.optimizer.state[p]["momentum_buffer"].numpy().copy()
                           for k, p in state_t.model.named_parameters()},
                          flax_to_state_dict(jax.tree_util.tree_map(
                              np.asarray, _find_trace(sj.opt_state)), {})),
                calls=calls, init=init))
        return results
    finally:
        mp.undo()


@pytest.fixture(scope="module")
def runs():
    return run_steps((queue_logsumexp, affine_relu_dot_moments), {"stem_kind": "s2d"},
                     backbone="ResNet50", fold_kernel=True)


@pytest.mark.parametrize("step", range(STEPS))
def test_step_metrics(runs, step):
    got, ref = runs[step]["metrics"]
    for k in METRICS:
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-4, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("step", range(STEPS))
@pytest.mark.parametrize("which", ["params", "key_params"])
def test_step_weights_and_batch_stats(runs, step, which):
    """Weights and BN running statistics of the query and key encoders. Each
    tensor's change since the start agrees to 5% in norm (0.4% after one step;
    the widest gaps are on updates of 1e-7, and on BN biases whose gradients
    are sums that cancel, computed in another order), and every element to
    5e-4 (1.8e-4 at worst: the derived-stat BN fold, E[y²]−μ² in f32,
    magnifies the order of summation)."""
    got, ref = runs[step][which]
    init = runs[step]["init"]
    assert set(got) == set(ref)
    for k in got:
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-4, atol=5e-4, err_msg=k)
        if which == "params":
            d_got, d_ref = got[k] - init[k], ref[k] - init[k]
            assert np.linalg.norm(d_got - d_ref) <= 5e-2 * np.linalg.norm(d_ref) + 1e-7, k


def check_momentum_buffers(got, ref):
    """The SGD momentum buffers, tensor by tensor, to 5% in norm (the gradients
    are f32 sums in another order through the whole backward; 1e-5 covers the
    buffers whose gradient is zero in exact arithmetic)."""
    assert set(got) == set(ref)
    for k in got:
        assert np.linalg.norm(got[k] - ref[k]) <= 5e-2 * np.linalg.norm(ref[k]) + 1e-5, k


@pytest.mark.parametrize("step", range(STEPS))
def test_step_momentum_buffers(runs, step):
    check_momentum_buffers(*runs[step]["momentum"])


@pytest.mark.parametrize("step", range(STEPS))
def test_step_queue(runs, step):
    (v, s, tail, total), (v_j, s_j, tail_j, total_j) = runs[step]["queue"]
    np.testing.assert_allclose(v, v_j, rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(s, s_j)
    assert (tail, total) == (tail_j, total_j) == ((step + 1) * BATCH % QUEUE, (step + 1) * BATCH)


@pytest.mark.parametrize("step", range(STEPS))
def test_step_runs_both_plain_kernels(runs, step):
    """Per step: one K1 call; K2 at the 10 sites of stages 2 and 3, in the key
    and the query forward."""
    assert runs[step]["calls"] == (1, 20)
