"""What the port's mesh-step tests share: the configuration (ResNet18, 32²
images, 8 videos x 2 frames, queue 64, embeddings 16, float32), the batches
made with numpy, JAX's step on a mesh of virtual devices, the JAX state as
the port's whole-state tree, and the port's one-device step.

Both packages read the batches as the augmented images (``_augment_sources``
is replaced on each side) and take one fixed shuffled-BN permutation (with
its a2a stages)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from vince_tpu.parallel import collectives as jc
from vince_tpu.parallel.mesh import MeshSpec, make_mesh
from vince_tpu.solvers import vince_step as jvs
from vince_tpu_torch.solvers import vince_step as tvs
from vince_tpu_torch.utils.checkpoint import state_tree
from vince_tpu_torch.utils.jax_weights import flax_to_state_dict, load_jax_state

BATCH, FRAMES, SIZE, QUEUE, EMBED, STEPS = 16, 2, 32, 64, 16, 3
METRIC_TOL = dict(rtol=2e-4, atol=2e-5)  # tests/test_multichip_parity.py's
PARAM_TOL = dict(rtol=1e-3, atol=1e-5)
SOURCE = dict(name="YT", batch_size=BATCH, num_frames=FRAMES, source_id=1)


def config(**options):
    """The config's fields shared by both packages (the source apart)."""
    return dict(backbone="ResNet18", embed_size=EMBED, image_size=SIZE, queue_size=QUEUE,
                temperature=0.07, momentum=0.999, **{"shuffle_bn": True, **options})


def batches(seed=7, steps=STEPS):
    rng = np.random.RandomState(seed)
    return [{"data": rng.rand(BATCH, SIZE, SIZE, 3).astype(np.float32),
             "queue_data": rng.rand(BATCH, SIZE, SIZE, 3).astype(np.float32)}
            for _ in range(steps)]


def perms(md, seed=5):
    """(perm, sigma, tau) of JAX's balanced permutation for a data axis of md."""
    return tuple(np.array(a) for a in
                 jc.make_balanced_shuffle_perm(jax.random.PRNGKey(seed), BATCH, md))


def patch(mp: pytest.MonkeyPatch, p):
    """Both packages' augmentations replaced by the batch's images, and their
    permutations by ``p`` = (perm, sigma, tau)."""
    perm = p[0]
    mp.setattr(jvs, "_augment_sources",
               lambda cfg, batch, rng, d_idx, mode="train": (batch[0]["data"],
                                                             batch[0]["queue_data"]))
    mp.setattr(jvs, "augment_batch", lambda rng, images, cfg, **kw: images.astype(kw["dtype"]))
    mp.setattr(jvs, "make_shuffle_perm", lambda rng, n: jnp.asarray(perm))
    mp.setattr(jvs, "make_balanced_shuffle_perm",
               lambda rng, n, d: tuple(jnp.asarray(a) for a in p))
    mp.setattr(tvs, "_augment_sources",
               lambda cfg, batch, draws: (batch[0]["data"], batch[0]["queue_data"]))
    mp.setattr(tvs, "make_shuffle_perm", lambda gen, n: torch.from_numpy(perm))


# options that leave the initial state as it is: the states of one initial
# key differ only by the model's structure
_STATE_NEUTRAL = ("shuffle_mode", "sync_bn")


@functools.lru_cache(maxsize=None)
def _initial(structure):
    options = dict(structure)
    cfg = jvs.VinceConfig(sources=(jvs.SourceSpec(**SOURCE),), compute_dtype=jnp.float32,
                          **config(**options))
    opt = jvs.build_vince_optimizer(optax.constant_schedule(0.05))
    init = jax.device_get(jax.jit(lambda key: jvs.init_vince_state(key, cfg, opt))(
        jax.random.PRNGKey(0)))
    return init, port_tree(init, options)


def initial_state(options):
    """JAX's initial state from ``PRNGKey(0)`` on the host, and as the port's
    whole-state tree, made once per process for the options that shape it
    (the mesh's sizes, the shuffle's mode and sync-BN do not): every mesh of
    a file starts from the same arrays. Callers read them and copy them into
    their own states."""
    return _initial(tuple(sorted((k, v) for k, v in options.items()
                                 if k not in _STATE_NEUTRAL)))


def jax_run(md, mq, options, what=("train",)):
    """JAX on an md x mq mesh of the virtual devices: the initial state as the
    port's tree, and the train steps' metrics, final weights (port names) and
    queue; the eval step's metrics and the prefill's embeddings on the first
    batch when ``what`` asks."""
    cfg = jvs.VinceConfig(sources=(jvs.SourceSpec(**SOURCE),), compute_dtype=jnp.float32,
                          data_axis_size=md, queue_axis_size=mq, **config(**options))
    opt = jvs.build_vince_optimizer(optax.constant_schedule(0.05))
    mesh = make_mesh(MeshSpec(md, mq))
    init, tree = initial_state(options)
    state = jvs.shard_state(jax.tree_util.tree_map(jnp.asarray, init), mesh)
    bs = batches()
    out = {"tree": tree}

    def device_batch(b):
        return ({k: jnp.asarray(v) for k, v in b.items()},)

    if "eval" in what:
        out["eval"] = {k: float(v) for k, v in
                       jvs.make_eval_step(cfg, mesh)(state, device_batch(bs[0]),
                                                     jax.random.PRNGKey(1)).items()}
    if "prefill" in what:
        out["prefill"] = np.asarray(jvs.make_key_prefill_fn(cfg, mesh, 0)(
            state, jnp.asarray(bs[0]["queue_data"]), jax.random.PRNGKey(1)))
    if "train" in what:
        step = jax.jit(jvs.make_train_step_fn(cfg, opt, mesh))
        out["metrics"] = []
        for b in bs:
            state, m = step(state, device_batch(b), jax.random.PRNGKey(9))
            out["metrics"].append({k: float(v) for k, v in m.items()})
        s = jax.device_get(state)
        out["params"] = flax_to_state_dict(jax.tree_util.tree_map(np.asarray, s.params),
                                           jax.tree_util.tree_map(np.asarray, s.batch_stats))
        out["queue"] = np.asarray(s.queue.vectors)
    return out


def port_config(**options):
    return tvs.VinceConfig(sources=(tvs.SourceSpec(**SOURCE),), **config(**options))


def port_tree(jax_state, options):
    """The JAX state as the port's whole-state tree (numpy), which each rank
    loads and cuts to its shard."""
    cfg = port_config(**options)
    state = tvs.init_vince_state(0, cfg, tvs.build_vince_optimizer(0.05), device="cpu")
    load_jax_state(state, jax.tree_util.tree_map(np.asarray, jax.device_get(jax_state)))
    return _numpy(state_tree(state))


def _numpy(tree):
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    return tree.detach().numpy().copy() if isinstance(tree, torch.Tensor) else tree


def port_single(tree, options):
    """The port's one-device steps from ``tree`` on the whole batches."""
    from vince_tpu_torch.utils.checkpoint import load_state_tree

    cfg = port_config(**options)
    opt = tvs.build_vince_optimizer(0.05)
    state = tvs.init_vince_state(0, cfg, opt, device="cpu")
    load_state_tree(state, {k: (v if not isinstance(v, dict) else
                                {n: torch.from_numpy(a) for n, a in v.items()})
                            for k, v in tree.items()})
    step = tvs.make_train_step_fn(cfg, opt)
    metrics = [{k: float(v) for k, v in
                step(state, ({k: torch.from_numpy(v) for k, v in b.items()},), 0)[1].items()}
               for b in batches()]
    return {"metrics": metrics, "params": _numpy(state.model.state_dict()),
            "queue": state.queue.vectors.numpy().copy()}


def assert_run_equal(got, ref, rows=STEPS * BATCH, what=""):
    """Metrics, weights and the queue's inserted rows of two runs."""
    for i, (g, r) in enumerate(zip(got["metrics"], ref["metrics"])):
        for k in r:
            np.testing.assert_allclose(float(g[k]), r[k], **METRIC_TOL,
                                       err_msg=f"{what} step {i} {k}")
    for k, v in ref["params"].items():
        np.testing.assert_allclose(got["params"][k], v, **PARAM_TOL, err_msg=f"{what} {k}")
    np.testing.assert_allclose(got["queue"][:rows], ref["queue"][:rows], **PARAM_TOL,
                               err_msg=f"{what} queue")


def run_meshes(meshes, options, one_device=(), against_jax=True):
    """JAX's run and the ranks' (``torch_port_ranks.mesh_step_rank``) on each
    (md, mq) mesh of ``meshes``, all from JAX's initial state; the ranks of
    meshes of one size run in one spawn. ``one_device`` names the one-device
    runs to add: "port" and "jax". Without ``against_jax`` JAX makes only the
    initial state. Returns the runs by mesh and the one-device runs by name."""
    out, single = run_jobs([(md, mq, options) for md, mq in meshes], one_device, against_jax)
    return {key[:2]: run for key, run in out.items()}, single


def run_jobs(jobs, one_device=(), against_jax=True):
    """``run_meshes`` for (md, mq, options) jobs, each its own options; the
    one-device runs take the first job's. The results by (md, mq, the
    options' items)."""
    from torch_port_ranks import mesh_jobs_rank, spawn

    mp = pytest.MonkeyPatch()
    try:
        refs, by_world = {}, {}
        for md, mq, options in jobs:
            patch(mp, perms(md))
            refs[md, mq, _key(options)] = jax_run(md, mq, options,
                                                  what=("train",) if against_jax else ())
            by_world.setdefault(md * mq, []).append((md, mq, options))
        out = {}
        for world, group in by_world.items():
            ranks = spawn(mesh_jobs_rank, world, [
                (md, mq, dict(config(**options), source=SOURCE),
                 refs[md, mq, _key(options)]["tree"], batches(), perms(md))
                for md, mq, options in group])
            for i, (md, mq, options) in enumerate(group):
                key = (md, mq, _key(options))
                out[key] = refs[key], [rank[i] for rank in ranks]
        single = {}
        options = jobs[0][2]
        patch(mp, perms(1))
        if "port" in one_device:
            single["port"] = port_single(initial_state(options)[1], options)
        if "jax" in one_device:
            single["jax"] = jax_run(1, 1, options)
        return out, single
    finally:
        mp.undo()


def _key(options):
    return tuple(sorted(options.items()))
