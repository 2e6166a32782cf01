"""The steps beside training, against ``vince_tpu.solvers.vince_step`` on a 1x1
mesh: ``make_eval_step`` (val-mode augmentation, train-mode BN that records
nothing), ``make_key_prefill_fn``, ``make_embed_fn`` (query and key encoder)
and ``make_panel_fn``, and ``load_jax_state``'s queue pointers and optimizer
traces. ResNet18, 32x32 crops, 8 frames (2 videos x 4), queue 64,
embeddings 128, fused InfoNCE, float32 on the CPU.

Both sides load one JAX state whose weights, statistics, key weights and key
statistics are perturbed from their init (so that the key encoder differs
from the query encoder, and eval-mode BN from the identity), with the queue's
pointers at tail 8, total 16. Each port step must leave the port's state
bit-identical."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vince_tpu.parallel.mesh import MeshSpec, make_mesh
from vince_tpu.solvers import vince_step as jvs
from vince_tpu.utils.schedules import vince_lr_schedule as jax_schedule
from vince_tpu_torch.ops.kernels.infonce_kernel import queue_logsumexp
from vince_tpu_torch.solvers import vince_step as tvs
from vince_tpu_torch.utils.jax_weights import _find_trace, flax_to_state_dict, load_jax_state
from vince_tpu_torch.utils.schedules import vince_lr_schedule
from torch_port_threads import one_intra_op_thread  # noqa: F401  (a module fixture)

BATCH, FRAMES, SIZE, CANVAS, QUEUE, EMBED = 8, 4, 32, 40, 64, 128
TAIL, TOTAL = 8, 16
SCHEDULE = dict(base_lr=0.03, epochs=4, iterations_per_epoch=1, use_warmup=False)
COMMON = dict(backbone="ResNet18", embed_size=EMBED, image_size=SIZE, queue_size=QUEUE,
              temperature=0.07, momentum=0.999, shuffle_bn=True, bn_fold="expand",
              use_fused_infonce=True)
SOURCE = dict(name="YT", batch_size=BATCH, num_frames=FRAMES,
              transform="StandardVideoTransform", source_id=1)


def _perturb(tree, rng, scale):
    return jax.tree_util.tree_map(
        lambda x: (x + scale * rng.randn(*x.shape)).astype(np.float32), tree)


@pytest.fixture(scope="module")
def setup():
    cfg_j = jvs.VinceConfig(sources=(jvs.SourceSpec(**SOURCE),), compute_dtype=jnp.float32,
                            **COMMON)
    cfg_t = tvs.VinceConfig(sources=(tvs.SourceSpec(**SOURCE),), compute_dtype=torch.float32,
                            **COMMON)
    opt_j = jvs.build_vince_optimizer(jax_schedule(**SCHEDULE))
    init = jax.jit(lambda key: jvs.init_vince_state(key, cfg_j, opt_j))
    s = jax.tree_util.tree_map(np.asarray, jax.device_get(init(jax.random.PRNGKey(0))))
    rng = np.random.RandomState(0)
    stats = lambda t: jax.tree_util.tree_map(  # noqa: E731
        lambda x: (rng.uniform(0.5, 1.5, x.shape) if x.min() > 0 else 0.1 * rng.randn(*x.shape)
                   ).astype(np.float32), t)
    s = s.replace(params=_perturb(s.params, rng, 0.02),
                  batch_stats=stats(s.batch_stats),
                  key_params=_perturb(s.key_params, rng, 0.02),
                  key_batch_stats=stats(s.key_batch_stats),
                  queue=s.queue.replace(tail=np.int32(TAIL), total=np.int32(TOTAL)))
    mesh = make_mesh(MeshSpec(data_axis_size=1, queue_axis_size=1))
    state_j = jvs.shard_state(jax.tree_util.tree_map(jnp.asarray, s), mesh)
    return dict(cfg_j=cfg_j, cfg_t=cfg_t, mesh=mesh, np_state=s, state_j=state_j)


def _port_state(setup, kind="sgd", np_state=None):
    opt = tvs.build_vince_optimizer(vince_lr_schedule(**SCHEDULE), kind)
    state = tvs.init_vince_state(0, setup["cfg_t"], opt, device="cpu")
    load_jax_state(state, setup["np_state"] if np_state is None else np_state)
    return state


def _snapshot(state):
    """Every tensor and count of the state, copied."""
    return dict(
        model={k: v.clone() for k, v in state.model.state_dict().items()},
        key_model={k: v.clone() for k, v in state.key_model.state_dict().items()},
        traces=[state.optimizer.state[p]["momentum_buffer"].clone()
                for p in state.optimizer.params],
        lr=state.optimizer.lr.clone(),
        queue=[t.clone() for t in (state.queue.vectors, state.queue.sources,
                                   state.queue.tail, state.queue.total)],
        counts=(state.step, state.queue.inserted))


def assert_unchanged(state, before):
    after = _snapshot(state)
    for part in ("model", "key_model"):
        for k, v in before[part].items():
            assert torch.equal(after[part][k], v), (part, k)
    for part in ("traces", "queue"):
        for x, y in zip(after[part], before[part]):
            assert torch.equal(x, y), part
    assert torch.equal(after["lr"], before["lr"])
    assert after["counts"] == before["counts"]


def _uint8(seed, size):
    return np.random.RandomState(seed).randint(0, 256, (BATCH, size, size, 3), np.uint8)


def _with_trace(opt_state, trace):
    """``opt_state`` with optax's ``TraceState`` holding ``trace``."""
    if "trace" in getattr(opt_state, "_fields", ()):
        return opt_state._replace(trace=trace)
    if isinstance(opt_state, tuple) and not hasattr(opt_state, "_fields"):
        return tuple(_with_trace(s, trace) for s in opt_state)
    return opt_state


@pytest.mark.parametrize("kind", ["sgd", "lars"])
def test_load_jax_state_carries_queue_pointers_and_traces(setup, kind):
    """The optax state of either kind, with a random trace where its
    ``TraceState`` sits (LARS holds the schedule's count ahead of it)."""
    opt_j = jvs.build_vince_optimizer(jax_schedule(**SCHEDULE), kind)
    params = setup["np_state"].params
    trace = _perturb(params, np.random.RandomState(1), 1.0)
    opt_state = _with_trace(opt_j.init(params), trace)
    assert _find_trace(opt_state) is trace
    np_state = setup["np_state"].replace(
        opt_state=jax.tree_util.tree_map(np.asarray, opt_state))
    state = _port_state(setup, kind, np_state)
    assert int(state.queue.tail) == TAIL and int(state.queue.total) == TOTAL
    assert state.queue.inserted == TOTAL and not state.queue.full
    assert state.queue.tail.dtype == torch.int32
    ref = flax_to_state_dict(trace, {})
    got = {k: state.optimizer.state[p]["momentum_buffer"]
           for k, p in state.model.named_parameters()}
    assert set(got) == set(ref)
    for k, v in ref.items():
        assert np.abs(v).max() > 0, k
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)


def test_eval_step_matches_jax_and_leaves_state(setup, monkeypatch):
    perm = np.random.RandomState(2).permutation(BATCH)
    monkeypatch.setattr(jvs, "make_shuffle_perm", lambda rng, n: jnp.asarray(perm))
    monkeypatch.setattr(tvs, "make_shuffle_perm", lambda gen, n: torch.from_numpy(perm))
    q, k = _uint8(3, CANVAS), _uint8(4, CANVAS)
    m_j = jvs.make_eval_step(setup["cfg_j"], setup["mesh"])(
        setup["state_j"], ({"data": jnp.asarray(q), "queue_data": jnp.asarray(k)},),
        jax.random.PRNGKey(0))
    state = _port_state(setup)
    before = _snapshot(state)
    plain = queue_logsumexp.plain_calls
    m_t = tvs.make_eval_step(setup["cfg_t"])(
        state, ({"data": torch.from_numpy(q), "queue_data": torch.from_numpy(k)},), 0)
    assert queue_logsumexp.plain_calls - plain == 1
    assert set(m_t) == set(m_j) == {"loss/nce_loss", *tvs.METRIC_KEYS}
    for key in m_j:
        np.testing.assert_allclose(float(m_t[key]), float(m_j[key]), rtol=1e-4, atol=1e-6,
                                   err_msg=key)
    assert_unchanged(state, before)


def test_key_prefill_matches_jax_and_leaves_state(setup, monkeypatch):
    """Both augmentations are replaced by the identity on the same float
    images; the train-mode forward of the key encoder drops its statistics."""
    monkeypatch.setattr(jvs, "augment_batch",
                        lambda rng, images, cfg, **kw: images.astype(kw["dtype"]))
    monkeypatch.setattr(tvs, "apply_augment",
                        lambda images, draws, cfg, dtype=torch.float32: images.to(dtype))
    images = np.random.RandomState(5).randn(BATCH, SIZE, SIZE, 3).astype(np.float32)
    e_j = jvs.make_key_prefill_fn(setup["cfg_j"], setup["mesh"], 0)(
        setup["state_j"], jnp.asarray(images), jax.random.PRNGKey(0))
    state = _port_state(setup)
    before = _snapshot(state)
    e_t = tvs.make_key_prefill_fn(setup["cfg_t"], 0)(state, torch.from_numpy(images), 0)
    assert e_t.dtype == torch.float32 and e_t.shape == (BATCH, EMBED)
    np.testing.assert_allclose(e_t.numpy(), np.asarray(e_j), rtol=0, atol=1e-5)
    assert_unchanged(state, before)


@pytest.mark.parametrize("use_key_encoder", [False, True])
def test_embed_matches_jax_and_leaves_state(setup, use_key_encoder):
    images = _uint8(6, SIZE)
    e_j, f_j = jvs.make_embed_fn(setup["cfg_j"], setup["mesh"], use_key_encoder)(
        setup["state_j"], jnp.asarray(images))
    state = _port_state(setup)
    before = _snapshot(state)
    e_t, f_t = tvs.make_embed_fn(setup["cfg_t"], use_key_encoder)(state, torch.from_numpy(images))
    assert e_t.dtype == f_t.dtype == torch.float32
    np.testing.assert_allclose(e_t.numpy(), np.asarray(e_j), rtol=0, atol=1e-5)
    np.testing.assert_allclose(f_t.numpy(), np.asarray(f_j), rtol=0, atol=1e-5)
    assert_unchanged(state, before)
    # the two encoders differ in this state, so each side took the one asked for
    other, _ = tvs.make_embed_fn(setup["cfg_t"], not use_key_encoder)(
        state, torch.from_numpy(images))
    assert (other - e_t).abs().max() > 1e-3


def test_panel_matches_jax_and_leaves_state(setup):
    images = _uint8(7, SIZE)
    out_j = jvs.make_panel_fn(setup["cfg_j"], setup["mesh"])(setup["state_j"], jnp.asarray(images))
    state = _port_state(setup)
    before = _snapshot(state)
    out_t = tvs.make_panel_fn(setup["cfg_t"])(state, torch.from_numpy(images))
    assert set(out_t) == set(out_j) == {"embeddings"}
    np.testing.assert_allclose(out_t["embeddings"].numpy(), np.asarray(out_j["embeddings"]),
                               rtol=0, atol=1e-5)
    assert_unchanged(state, before)
