"""The step's head branches against ``vince_tpu.solvers.vince_step`` on a 1x1
mesh, ResNet18, queue 64, embeddings 32, float32 on the CPU: a train step of
two sources (IN with ImageNet CE and labels, YT) with the attention pool and
self-batch InfoNCE (the optimizer, the EMA and the queue over more steps are
``test_torch_port_step.py``'s).

This file holds the runner and the checks that the jigsaw step files
(``test_torch_port_step_jigsaw*.py``) share; each file compiles one JAX
step, so that each stays cheap. Both sides get the same numpy-made images,
the same shuffled-BN permutation and the same jigsaw permutations:
``_augment_sources``, ``make_shuffle_perm`` and ``random_jigsaw_perms`` are
replaced in each side's ``vince_step`` module, the last by the same
sequence of permutations on both sides. The JAX state is built from
``jax.eval_shape`` of its init and filled with numpy, so nothing but the
step is compiled. Every test here runs a ResNet18, whose basic blocks' last
BatchNorm starts at scale 0 in flax."""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vince_tpu.parallel.mesh import MeshSpec, make_mesh
from vince_tpu.solvers import vince_step as jvs
from vince_tpu.utils.schedules import vince_lr_schedule as jax_schedule
from vince_tpu_torch.models.vince_model import split_vince_params
from vince_tpu_torch.ops.kernels.infonce_kernel import queue_logsumexp
from vince_tpu_torch.solvers import vince_step as tvs
from vince_tpu_torch.utils.jax_weights import _find_trace, flax_to_state_dict, load_jax_state
from vince_tpu_torch.utils.schedules import vince_lr_schedule
from torch_port_threads import one_intra_op_thread  # noqa: F401  (a module fixture)

QUEUE, EMBED, CLASSES = 64, 32, 1000
SCHEDULE = dict(base_lr=0.03, epochs=4, iterations_per_epoch=1, use_warmup=False)
COMMON = dict(backbone="ResNet18", embed_size=EMBED, queue_size=QUEUE, temperature=0.07,
              momentum=0.999, shuffle_bn=True, bn_fold="expand", use_fused_infonce=True)
# IN (2 images x 2 views, CE) and YT (2 videos x 2 frames), 48x48
HEADS = dict(image_size=48, use_attention=True, self_batch=True, self_temperature=0.1)
HEAD_SOURCES = (dict(name="IN", batch_size=4, num_frames=2, transform="RepeatedImagenetTransform",
                     use_imagenet_ce=True, source_id=0),
                dict(name="YT", batch_size=4, num_frames=2,
                     transform="StandardVideoTransform", source_id=1))
# one source of 4 videos x 2 frames, 33x33
JIGSAW = dict(image_size=33, jigsaw=True)
JIGSAW_SOURCES = (dict(name="YT", batch_size=8, num_frames=2, transform="JigsawTransform",
                       source_id=1),)


def _configs(sources, **options):
    cfg_j = jvs.VinceConfig(sources=tuple(jvs.SourceSpec(**s) for s in sources),
                            compute_dtype=jnp.float32, **COMMON, **options)
    cfg_t = tvs.VinceConfig(sources=tuple(tvs.SourceSpec(**s) for s in sources),
                            compute_dtype=torch.float32, **COMMON, **options)
    return cfg_j, cfg_t


def _batches(sources, size, steps, seed):
    """Per step, per source: augmented float images for query and key, and
    labels for a CE source (numpy)."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(steps):
        step = []
        for s in sources:
            b = {"data": rng.randn(s["batch_size"], size, size, 3).astype(np.float32),
                 "queue_data": rng.randn(s["batch_size"], size, size, 3).astype(np.float32)}
            if s.get("use_imagenet_ce"):
                b["labels"] = rng.randint(0, CLASSES, s["batch_size"]).astype(np.int32)
            step.append(b)
        out.append(step)
    return out


def _patch(mp, total, jigsaw_calls):
    """Replace the draws on both sides; ``jigsaw_calls`` permutations a step,
    handed out in the order the step asks for them (key, query, align)."""
    rng = np.random.RandomState(1)
    perm = rng.permutation(total)
    perms = [np.stack([rng.permutation(9) for _ in range(total)]) for _ in range(jigsaw_calls)]
    mp.setattr(jvs, "_augment_sources",
               lambda cfg, batch, rng, d_idx, mode="train": (
                   jnp.concatenate([b["data"] for b in batch]),
                   jnp.concatenate([b["queue_data"] for b in batch])))
    mp.setattr(tvs, "_augment_sources",
               lambda cfg, batch, draws: (torch.cat([b["data"] for b in batch]),
                                          torch.cat([b["queue_data"] for b in batch])))
    mp.setattr(jvs, "make_shuffle_perm", lambda rng, n: jnp.asarray(perm))
    mp.setattr(tvs, "make_shuffle_perm", lambda gen, n: torch.from_numpy(perm))
    j_cycle, t_cycle = itertools.cycle(perms), itertools.cycle(perms)
    mp.setattr(jvs, "random_jigsaw_perms",
               lambda rng, n: jnp.asarray(next(j_cycle), jnp.int32))
    mp.setattr(tvs, "random_jigsaw_perms", lambda gen, n: torch.from_numpy(next(t_cycle)))


def jax_state(cfg_j, seed=0):
    """A JAX ``VinceState`` of the config with numpy leaves, and its optimizer:
    the shapes from ``jax.eval_shape`` of ``init_vince_state`` (nothing
    compiled), the values as flax's init makes them (kernels lecun-normal
    from ``seed``, norm scales 1 but the basic blocks' last at 0, biases and
    means 0, variances 1); the key encoder a copy of the tracked part, the
    optimizer's state from its ``init``, random unit rows in the queue."""
    opt_j = jvs.build_vince_optimizer(jax_schedule(**SCHEDULE))
    shapes = jax.eval_shape(lambda key: jvs.init_vince_state(key, cfg_j, opt_j),
                            jax.random.PRNGKey(0))
    rng = np.random.RandomState(seed)

    def fill(path, leaf):
        keys = [k.key for k in path]
        if keys[-1] == "kernel":
            return (rng.randn(*leaf.shape) / np.sqrt(np.prod(leaf.shape[:-1]))).astype(np.float32)
        one = keys[-1] == "var" or (keys[-1] == "scale" and keys[-2] != "bn2")
        return np.full(leaf.shape, float(one), np.float32)

    params = jax.tree_util.tree_map_with_path(fill, shapes.params)
    stats = jax.tree_util.tree_map_with_path(fill, shapes.batch_stats)
    tracked, _ = jvs.split_vince_params(params)
    copy = lambda tree: jax.tree_util.tree_map(np.copy, tree)  # noqa: E731
    vectors = rng.randn(cfg_j.queue_size, cfg_j.embed_size)
    queue = shapes.queue.replace(
        vectors=(vectors / np.linalg.norm(vectors, axis=-1, keepdims=True)).astype(np.float32),
        sources=np.full(cfg_j.queue_size, -1, np.int32), tail=np.int32(0), total=np.int32(0))
    return shapes.replace(step=np.int32(0), params=params, batch_stats=stats,
                          key_params=copy(tracked), key_batch_stats=copy(stats),
                          opt_state=jax.tree_util.tree_map(np.asarray, opt_j.init(params)),
                          queue=queue), opt_j


def _tracked(tree):
    """The state-dict entries of the EMA-tracked modules (a key encoder's)."""
    tracked, _ = split_vince_params(tree)
    return tracked


def run_steps(sources, options, jigsaw_side, steps, jigsaw_calls=0):
    """``steps`` train steps of both packages from one state; per step the
    metrics, weights, statistics, traces and queue of each side, and the
    plain K1 calls."""
    cfg_j, cfg_t = _configs(sources, **options)
    batches = _batches(sources, cfg_t.image_size, steps, seed=0)
    mp = pytest.MonkeyPatch()
    _patch(mp, cfg_t.total_batch, jigsaw_calls)
    try:
        np_state, opt_j = jax_state(cfg_j)
        mesh = make_mesh(MeshSpec(data_axis_size=1, queue_axis_size=1))
        state_j = jvs.shard_state(jax.tree_util.tree_map(jnp.asarray, np_state), mesh)
        step_j = jax.jit(jvs.make_train_step_fn(cfg_j, opt_j, mesh, jigsaw_side))
        opt_t = tvs.build_vince_optimizer(vince_lr_schedule(**SCHEDULE))
        state_t = tvs.init_vince_state(0, cfg_t, opt_t, device="cpu")
        load_jax_state(state_t, np_state)
        step_t = tvs.make_train_step_fn(cfg_t, opt_t, jigsaw_side)
        init = {k: v.detach().numpy().copy() for k, v in state_t.model.state_dict().items()}
        results = []
        for batch in batches:
            state_j, m_j = step_j(state_j, tuple({k: jnp.asarray(v) for k, v in b.items()}
                                                 for b in batch), jax.random.PRNGKey(1))
            plain = queue_logsumexp.plain_calls
            state_t, m_t = step_t(state_t, tuple({k: torch.from_numpy(v) for k, v in b.items()}
                                                 for b in batch), 0)
            sj = jax.device_get(state_j)
            key_ref = flax_to_state_dict({**sj.params, **sj.key_params}, sj.key_batch_stats)
            results.append(dict(
                metrics=({k: float(v) for k, v in m_t.items()},
                         {k: float(v) for k, v in m_j.items()}),
                params=({k: v.detach().numpy().copy()
                         for k, v in state_t.model.state_dict().items()},
                        flax_to_state_dict(sj.params, sj.batch_stats)),
                key_params=(_tracked({k: v.detach().numpy().copy()
                                      for k, v in state_t.key_model.state_dict().items()}),
                            _tracked(key_ref)),
                queue=((state_t.queue.vectors.numpy().copy(), state_t.queue.sources.numpy().copy(),
                        int(state_t.queue.tail), int(state_t.queue.total)),
                       (np.asarray(sj.queue.vectors), np.asarray(sj.queue.sources),
                        int(sj.queue.tail), int(sj.queue.total))),
                momentum=({k: state_t.optimizer.state[p]["momentum_buffer"].numpy().copy()
                           for k, p in state_t.model.named_parameters()},
                          flax_to_state_dict(jax.tree_util.tree_map(
                              np.asarray, _find_trace(sj.opt_state)), {})),
                k1_calls=queue_logsumexp.plain_calls - plain, init=init))
        return results
    finally:
        mp.undo()


BASE = {"loss/total_loss", "loss/nce_loss", *tvs.METRIC_KEYS}
HEAD_METRICS = {"loss/nce_loss_self", "nce_accuracy_self", "loss/imagenet_loss_0",
                "loss/imagenet_loss_1", "imagenet_accuracy_0", "imagenet_accuracy_1"}


def variant_runs(sources, options, side, steps, jigsaw_calls, extra, k1):
    """A variant's steps: ``steps`` train steps with ``side``, taking
    ``jigsaw_calls`` jigsaw permutations a step, with the metrics ``extra``
    beyond the base ones and ``k1`` K1 calls a step."""
    return dict(results=run_steps(sources, options, side, steps, jigsaw_calls), extra=extra,
                k1=k1)


@pytest.fixture(scope="module")
def runs():
    return variant_runs(HEAD_SOURCES, HEADS, None, 1, 0, HEAD_METRICS, 2)


def check_metrics(runs):
    """Every metric of JAX's step under its name, each loss term and the
    total, to 1e-4 relative."""
    for r in runs["results"]:
        got, ref = r["metrics"]
        assert set(got) == set(ref) == BASE | runs["extra"]
        for k in ref:
            np.testing.assert_allclose(got[k], ref[k], rtol=1e-4, atol=1e-6, err_msg=k)
        np.testing.assert_allclose(
            got["loss/total_loss"], sum(v for k, v in got.items()
                                        if k.startswith("loss/") and k != "loss/total_loss"),
            rtol=1e-6)


def check_weights_and_batch_stats(runs, which):
    """Weights (the decoders, the pool and the jigsaw head included) and BN
    running statistics of the query encoder and the key encoder's tracked
    modules, with the bounds of ``test_torch_port_step.py``: every element to
    rtol 1e-4 plus 5e-4, and each tensor's change to 5% in norm."""
    for r in runs["results"]:
        got, ref = r[which]
        init = r["init"]
        assert set(got) == set(ref)
        for k in got:
            np.testing.assert_allclose(got[k], ref[k], rtol=1e-4, atol=5e-4, err_msg=k)
            if which == "params":
                d_got, d_ref = got[k] - init[k], ref[k] - init[k]
                assert np.linalg.norm(d_got - d_ref) <= 5e-2 * np.linalg.norm(d_ref) + 1e-7, k


def check_momentum_buffers(runs):
    """The momentum traces to 5% in norm, as ``test_torch_port_step.py``."""
    for r in runs["results"]:
        got, ref = r["momentum"]
        assert set(got) == set(ref)
        for k in got:
            assert np.linalg.norm(got[k] - ref[k]) <= 5e-2 * np.linalg.norm(ref[k]) + 1e-5, k


def check_queue_and_k1_calls(runs):
    """The queue after each step, and one K1 call per source (self-batch and
    alignment read no queue)."""
    for step, r in enumerate(runs["results"]):
        (v, s, tail, total), (v_j, s_j, tail_j, total_j) = r["queue"]
        np.testing.assert_allclose(v, v_j, rtol=1e-4, atol=1e-5)
        np.testing.assert_array_equal(s, s_j)
        assert (tail, total) == (tail_j, total_j) == ((step + 1) * 8 % QUEUE, (step + 1) * 8)
        assert r["k1_calls"] == runs["k1"]


def test_step_metrics(runs):
    check_metrics(runs)


@pytest.mark.parametrize("which", ["params", "key_params"])
def test_step_weights_and_batch_stats(runs, which):
    check_weights_and_batch_stats(runs, which)


def test_step_momentum_buffers(runs):
    check_momentum_buffers(runs)


def test_step_queue_and_k1_calls(runs):
    check_queue_and_k1_calls(runs)
