"""The panel's attention masks and decoder logits against
``vince_tpu.solvers.vince_step`` on the state of
``test_torch_port_eval_heads.py`` (ResNet18, float32 on the CPU); the
query-side jigsaw with a CE source, which both packages refuse; and the
jigsaw permutations that a step draws for each side."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_port_eval_heads import (  # noqa: F401
    _assert_unchanged, _port_state, _snapshot, _uint8_batch, heads_state)
from tests.test_torch_port_step_heads import (
    CLASSES, HEAD_SOURCES, JIGSAW, JIGSAW_SOURCES, _batches, _configs, jax_state)
from vince_tpu.parallel.mesh import MeshSpec, make_mesh
from vince_tpu.solvers import vince_step as jvs
from vince_tpu_torch.solvers import vince_step as tvs
from torch_port_threads import one_intra_op_thread  # noqa: F401  (a module fixture)


@pytest.mark.parametrize("side", ["query", "both"])
def test_jigsaw_query_side_with_imagenet_ce_is_refused(side):
    """A query-side jigsaw feeds the decoders the jigsaw head's embed-wide
    output: the JAX step fails at trace time on the decoders' shapes; the
    port refuses the build with a ValueError."""
    sources = (dict(HEAD_SOURCES[0]),)
    cfg_j, cfg_t = _configs(sources, **JIGSAW)
    with pytest.raises(ValueError, match="ImageNet decoders"):
        tvs.make_train_step_fn(cfg_t, tvs.build_vince_optimizer(0.03), side)
    with pytest.raises(ValueError, match="ImageNet decoders"):
        tvs.make_train_step(cfg_t, tvs.build_vince_optimizer(0.03), side)
    if side == "query":  # traced only
        state_j, opt_j = jax_state(cfg_j)
        mesh = make_mesh(MeshSpec(data_axis_size=1, queue_axis_size=1))
        step_j = jvs.make_train_step_fn(cfg_j, opt_j, mesh, side)
        batch = tuple({k: jnp.asarray(v) for k, v in b.items()}
                      for b in _batches(sources, 33, 1, seed=2)[0])
        with pytest.raises(Exception, match="imagenet_decoder_0"):
            jax.eval_shape(step_j, state_j, batch, jax.random.PRNGKey(0))
    # the key side's query pass is the plain one: accepted
    tvs.make_train_step_fn(cfg_t, tvs.build_vince_optimizer(0.03), "key")


def test_jigsaw_side_needs_the_head():
    _, cfg_t = _configs(JIGSAW_SOURCES, image_size=33)
    with pytest.raises(ValueError, match="jigsaw"):
        tvs.make_train_step_fn(cfg_t, tvs.build_vince_optimizer(0.03), "query")
    with pytest.raises(ValueError, match="jigsaw_side"):
        tvs.make_train_step_fn(cfg_t, tvs.build_vince_optimizer(0.03), "patches")


@pytest.mark.parametrize("side,align,roles", [
    (None, 0.5, ()), ("query", 0.0, ("query",)), ("key", 0.0, ("key",)),
    ("both", 0.5, ("key", "query")), ("query", 0.5, ("query",)),
    ("key", 0.5, ("key", "align"))])
@pytest.mark.parametrize("identity", [False, True])
def test_step_draws_the_jigsaw_permutations_of_each_jigsaw_forward(side, align, roles,
                                                                    identity):
    """One [B, 9] permutation per forward on the jigsaw path, in the order
    the JAX step asks for them (key, query, the alignment pass's when it
    runs the jigsaw head, i.e. on a key-side step); the identity with
    ``jigsaw_identity_perms``, as the JAX step's diagnostic control."""
    _, cfg_t = _configs(JIGSAW_SOURCES, **JIGSAW, jigsaw_align_weight=align,
                        jigsaw_identity_perms=identity)
    batch = tuple({k: torch.from_numpy(v) for k, v in b.items()}
                  for b in _batches(JIGSAW_SOURCES, 40, 1, seed=3)[0])
    draws = tvs._draw_step(cfg_t, batch, seed=0, step=0, jigsaw_side=side)
    assert tuple(draws.jigsaw) == roles
    for perm in draws.jigsaw.values():
        assert perm.shape == (8, 9) and perm.dtype == torch.int64
        assert (perm.sort(dim=1).values == torch.arange(9)).all()
        assert (perm == torch.arange(9)).all() == identity
    again = tvs._draw_step(cfg_t, batch, seed=0, step=0, jigsaw_side=side)
    assert all(torch.equal(draws.jigsaw[r], again.jigsaw[r]) for r in roles)


def test_panel_with_heads_matches_jax_and_leaves_state(heads_state):
    images = _uint8_batch(4, 48)[0]["data"]
    out_j = jvs.make_panel_fn(heads_state["cfg_j"], heads_state["mesh"])(
        heads_state["state_j"], jnp.asarray(images))
    state = _port_state(heads_state)
    before = _snapshot(state)
    out_t = tvs.make_panel_fn(heads_state["cfg_t"])(state, torch.from_numpy(images))
    assert set(out_t) == set(out_j) == {"embeddings", "attention_masks", "imagenet_logits_0",
                                        "imagenet_logits_1"}
    for k in out_j:
        assert out_t[k].dtype == torch.float32 and out_t[k].shape == out_j[k].shape
        np.testing.assert_allclose(out_t[k].numpy(), np.asarray(out_j[k]), rtol=1e-4,
                                   atol=1e-5, err_msg=k)
    np.testing.assert_allclose(out_t["attention_masks"].sum(dim=(1, 2, 3)).numpy(), 1.0,
                               rtol=1e-5)
    assert out_t["imagenet_logits_0"].shape == (4, CLASSES)
    _assert_unchanged(state, before)
