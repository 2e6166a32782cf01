"""The head branches of the eval step against ``vince_tpu.solvers.vince_step``
on a 1x1 mesh (ResNet18, queue 64, embeddings 32, float32 on the CPU): its
self-batch and CE terms, on a state whose key encoder differs from its query
encoder, and ``load_jax_state`` with every head. The panel is in
``test_torch_port_panel_heads.py``, which shares this file's state."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_port_step_heads import (
    BASE, CLASSES, HEAD_METRICS, HEAD_SOURCES, HEADS, SCHEDULE, _configs, jax_state)
from vince_tpu.parallel.mesh import MeshSpec, make_mesh
from vince_tpu.solvers import vince_step as jvs
from vince_tpu_torch.solvers import vince_step as tvs
from vince_tpu_torch.utils.jax_weights import _find_trace, flax_to_state_dict, load_jax_state
from vince_tpu_torch.utils.schedules import vince_lr_schedule
from torch_port_threads import one_intra_op_thread  # noqa: F401  (a module fixture)


def _with_trace(opt_state, trace):
    """``opt_state`` with optax's ``TraceState`` holding ``trace``."""
    if "trace" in getattr(opt_state, "_fields", ()):
        return opt_state._replace(trace=trace)
    if isinstance(opt_state, tuple) and not hasattr(opt_state, "_fields"):
        return tuple(_with_trace(t, trace) for t in opt_state)
    return opt_state


def _perturb(tree, rng, scale):
    return jax.tree_util.tree_map(
        lambda x: (x + scale * rng.randn(*x.shape)).astype(np.float32), tree)


@pytest.fixture(scope="module")
def heads_state():
    """The heads configuration's JAX state with its weights, statistics, key
    weights, key statistics and momentum traces moved off their init."""
    cfg_j, cfg_t = _configs(HEAD_SOURCES, **HEADS)
    s, _ = jax_state(cfg_j)
    rng = np.random.RandomState(1)
    stats = lambda t: jax.tree_util.tree_map(  # noqa: E731
        lambda x: (rng.uniform(0.5, 1.5, x.shape) if x.min() > 0 else 0.1 * rng.randn(*x.shape)
                   ).astype(np.float32), t)
    trace = _perturb(s.params, rng, 1.0)
    s = s.replace(params=_perturb(s.params, rng, 0.02), batch_stats=stats(s.batch_stats),
                  key_params=_perturb(s.key_params, rng, 0.02),
                  key_batch_stats=stats(s.key_batch_stats),
                  opt_state=_with_trace(s.opt_state, trace))
    assert _find_trace(s.opt_state) is trace
    mesh = make_mesh(MeshSpec(data_axis_size=1, queue_axis_size=1))
    return dict(cfg_j=cfg_j, cfg_t=cfg_t, np_state=s, mesh=mesh,
                state_j=jvs.shard_state(jax.tree_util.tree_map(jnp.asarray, s), mesh))


def _port_state(h):
    opt = tvs.build_vince_optimizer(vince_lr_schedule(**SCHEDULE))
    state = tvs.init_vince_state(0, h["cfg_t"], opt, device="cpu")
    load_jax_state(state, h["np_state"])
    return state


def _snapshot(state):
    return ([v.clone() for v in state.model.state_dict().values()]
            + [v.clone() for v in state.key_model.state_dict().values()]
            + [state.optimizer.state[p]["momentum_buffer"].clone()
               for p in state.optimizer.params]
            + [t.clone() for t in (state.queue.vectors, state.queue.tail, state.queue.total)],
            (state.step, state.queue.inserted))


def _assert_unchanged(state, before):
    after = _snapshot(state)
    assert after[1] == before[1]
    assert all(torch.equal(x, y) for x, y in zip(after[0], before[0]))


def test_load_jax_state_with_heads(heads_state):
    """Query weights and statistics with every head, the key encoder's
    tracked modules from ``key_params`` and its decoders from ``params``, and
    the traces of the heads."""
    s = heads_state["np_state"]
    state = _port_state(heads_state)
    for model, ref in ((state.model, flax_to_state_dict(s.params, s.batch_stats)),
                       (state.key_model, flax_to_state_dict({**s.params, **s.key_params},
                                                            s.key_batch_stats))):
        got = model.state_dict()
        assert set(got) == set(ref)
        assert any(k.startswith("pool.attn_logits") for k in got)
        for k, v in ref.items():
            np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)
    key = state.key_model.state_dict()
    np.testing.assert_array_equal(  # the tracked pool from key_params, not params
        key["pool.attn_logits.weight"].numpy().ravel(),
        np.asarray(s.key_params["pool"]["attn_logits"]["kernel"]).ravel())
    ref = flax_to_state_dict(_find_trace(s.opt_state), {})
    got = {k: state.optimizer.state[p]["momentum_buffer"]
           for k, p in state.model.named_parameters()}
    assert set(got) == set(ref) and any(k.startswith("imagenet_decoder_1") for k in got)
    for k, v in ref.items():
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)


def _uint8_batch(seed, size):
    rng = np.random.RandomState(seed)
    out = []
    for s in HEAD_SOURCES:
        b = {"data": rng.randint(0, 256, (s["batch_size"], size, size, 3), np.uint8),
             "queue_data": rng.randint(0, 256, (s["batch_size"], size, size, 3), np.uint8)}
        if s.get("use_imagenet_ce"):
            b["labels"] = rng.randint(0, CLASSES, s["batch_size"]).astype(np.int32)
        out.append(b)
    return out


def test_eval_step_with_heads_matches_jax_and_leaves_state(heads_state, monkeypatch):
    """Self-batch and CE terms in the val-mode step (both sources are videos,
    so the val path draws nothing), under JAX's names and with no total."""
    perm = np.random.RandomState(2).permutation(8)
    monkeypatch.setattr(jvs, "make_shuffle_perm", lambda rng, n: jnp.asarray(perm))
    monkeypatch.setattr(tvs, "make_shuffle_perm", lambda gen, n: torch.from_numpy(perm))
    batch = _uint8_batch(3, 56)
    m_j = jvs.make_eval_step(heads_state["cfg_j"], heads_state["mesh"])(
        heads_state["state_j"], tuple({k: jnp.asarray(v) for k, v in b.items()} for b in batch),
        jax.random.PRNGKey(0))
    state = _port_state(heads_state)
    before = _snapshot(state)
    m_t = tvs.make_eval_step(heads_state["cfg_t"])(
        state, tuple({k: torch.from_numpy(v) for k, v in b.items()} for b in batch), 0)
    assert set(m_t) == set(m_j) == (BASE - {"loss/total_loss"}) | HEAD_METRICS
    for k in m_j:
        np.testing.assert_allclose(float(m_t[k]), float(m_j[k]), rtol=1e-4, atol=1e-6,
                                   err_msg=k)
    _assert_unchanged(state, before)
