"""``remat`` in the port (``models/resnet.py::remat_block``) against
``vince_tpu``'s ``nn.remat``, which has no test of its own in the JAX
package:

- a Bottleneck on the fold chain with K2's site (its plain version on the
  CPU) and an MBConv with ``dw_kind="kernel"`` (K4's plain version), each
  through ``remat_block`` against JAX's ``nn.remat`` of the block: the output
  at 1e-5, the parameter gradients at 1e-5 of their norm as one vector (each
  tensor at 2e-5 of its own), the running averages after the call at 1e-6,
  and the recompute seen in the kernel's plain calls; the same block without
  remat gives the same bits;
- a whole ResNet18 train step with ``remat=True`` against JAX's, at the
  tolerances of ``test_torch_port_step.py``, and the port's remat step equal
  to its step without remat bit for bit, running averages included.

Both packages read the same numpy batches as the augmented images and take
one fixed shuffled-BN permutation, as in ``test_torch_port_step.py``."""

import copy
import functools

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vince_tpu.models.efficientnet import MBConv as JaxMBConv
from vince_tpu.models.resnet import Bottleneck as JaxBottleneck
from vince_tpu.models.resnet import FoldCfg
from vince_tpu.parallel.mesh import MeshSpec, make_mesh
from vince_tpu.solvers import vince_step as jvs
from vince_tpu_torch.models.efficientnet import BN_EPSILON, BN_MOMENTUM, MBConv
from vince_tpu_torch.models.resnet import Bottleneck, remat_block
from vince_tpu_torch.ops.kernels.depthwise_kernel import depthwise_conv
from vince_tpu_torch.ops.kernels.folded_dot_kernel import affine_relu_dot_moments
from vince_tpu_torch.solvers import vince_step as tvs
from vince_tpu_torch.utils.jax_weights import _find_trace, flax_to_state_dict, load_jax_state
from torch_port_threads import one_intra_op_thread  # noqa: F401  (a module fixture)

# Bottleneck: 2 images of 8x8, C = 128, F = 512: one K2 site (M = 128).
# MBConv: 16 -> 96 -> 16 channels, 5x5 depthwise at stride 1 (K4), a residual.
BLOCKS = {
    "bottleneck": dict(
        x=(2, 8, 8, 64), prefix="layer1_0",
        port=lambda: Bottleneck(64, 128, downsample=True, fold=True, fold_kernel=True),
        jax=lambda: fnn.remat(JaxBottleneck)(
            filters=128, downsample=True,
            norm=functools.partial(fnn.BatchNorm, use_running_average=False, momentum=0.9,
                                   epsilon=1e-5),
            fold_cfg=FoldCfg(train=True, momentum=0.9, epsilon=1e-5, dtype=jnp.float32,
                             axis_name=None, use_kernel=True))),
    # on the CPU JAX's "pallas" depthwise kind runs its grouped convolution
    "mbconv": dict(
        x=(2, 8, 8, 16), prefix="block_0",
        port=lambda: MBConv(16, 16, 6, 5, 1, fold=True, dw_kind="kernel"),
        jax=lambda: fnn.remat(JaxMBConv)(
            filters=16, expand_ratio=6, kernel=5, strides=1, dw_kind="pallas",
            norm=functools.partial(fnn.BatchNorm, use_running_average=False,
                                   momentum=BN_MOMENTUM, epsilon=BN_EPSILON),
            fold_cfg=FoldCfg(train=True, momentum=BN_MOMENTUM, epsilon=BN_EPSILON,
                             dtype=jnp.float32, axis_name=None))),
}


def _perturb(tree, rng):
    """BatchNorm scales 1 ± 0.5, so that no branch starts at zero."""
    return {k: _perturb(v, rng) if isinstance(v, dict) else
            (v + 0.5 * rng.randn(*v.shape).astype(np.float32) if k == "scale" else v)
            for k, v in tree.items()}


def _block_arrays(prefix, params, stats):
    """One flax block's trees → the port block's state-dict names."""
    arrays = flax_to_state_dict({"backbone": {prefix: params}}, {"backbone": {prefix: stats}})
    head = "backbone." + {"layer1_0": "layer1.0.", "block_0": "_blocks.0."}[prefix]
    return {k[len(head):]: v for k, v in arrays.items()}


def _port_call(block, x, remat):
    """Output, parameter gradients, state after the call and the kernel's
    plain calls of one train-mode call and its backward."""
    wrapper_calls = (affine_relu_dot_moments.plain_calls, depthwise_conv.plain_calls)
    xt = torch.from_numpy(x)
    out = remat_block(block, xt) if remat else block(xt)
    ((out ** 2).sum() * 1e-3).backward()
    calls = (affine_relu_dot_moments.plain_calls - wrapper_calls[0],
             depthwise_conv.plain_calls - wrapper_calls[1])
    return (out.detach().numpy(), {k: p.grad.numpy() for k, p in block.named_parameters()},
            {k: v.numpy().copy() for k, v in block.state_dict().items()}, calls)


@pytest.mark.parametrize("name", list(BLOCKS))
def test_remat_block_matches_jax_remat(name):
    spec = BLOCKS[name]
    x = np.random.RandomState(4).rand(*spec["x"]).astype(np.float32)
    jm = spec["jax"]()
    variables = jax.device_get(jax.jit(jm.init)({"params": jax.random.PRNGKey(0)},
                                                jnp.asarray(x)))
    params = _perturb(variables["params"], np.random.RandomState(5))

    def loss(p):
        out, mut = jm.apply({"params": p, "batch_stats": variables["batch_stats"]},
                            jnp.asarray(x), mutable=["batch_stats"])
        return jnp.sum(out ** 2) * 1e-3, (out, mut["batch_stats"])

    (_, (out, stats)), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
    ref_grads = _block_arrays(spec["prefix"], jax.device_get(grads), {})
    ref_state = _block_arrays(spec["prefix"], params, jax.device_get(stats))

    block = spec["port"]().train()
    block.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in
                           _block_arrays(spec["prefix"], params,
                                         variables["batch_stats"]).items()})
    plain = copy.deepcopy(block)
    got_out, got_grads, got_state, calls = _port_call(block, x, remat=True)

    ref_out = np.asarray(out)
    np.testing.assert_allclose(got_out, ref_out, rtol=1e-5, atol=1e-5 * np.abs(ref_out).max())
    assert set(got_grads) == set(ref_grads)
    names = sorted(ref_grads)
    flat_got = np.concatenate([got_grads[k].ravel() for k in names])
    flat_ref = np.concatenate([ref_grads[k].ravel() for k in names])
    assert np.linalg.norm(flat_got - flat_ref) <= 1e-5 * np.linalg.norm(flat_ref)
    for k, g in ref_grads.items():
        assert np.abs(g).max() > 0, k  # every branch carries gradient
        # per tensor 2e-5 in norm: the downsample conv's gradient, through the
        # folded statistics' E[y²]−μ², sits at 1.3e-5 (f32 order of the sums)
        assert np.linalg.norm(got_grads[k] - g) <= 2e-5 * np.linalg.norm(g), k
    stat_names = [k for k in ref_state if k.endswith(("running_mean", "running_var"))]
    assert stat_names
    for k in stat_names:
        np.testing.assert_allclose(got_state[k], ref_state[k], rtol=1e-6, atol=1e-6, err_msg=k)

    # the recompute reran the kernel's forward: one site, so 2 calls with
    # remat (K4: forward, recompute, dgrad = 3), one fewer without
    k2_calls, k4_calls = calls
    assert (k2_calls, k4_calls) == ((2, 0) if name == "bottleneck" else (0, 3))
    p_out, p_grads, p_state, p_calls = _port_call(plain, x, remat=False)
    assert sum(p_calls) == sum(calls) - 1
    assert np.array_equal(p_out, got_out)
    for k in p_grads:
        assert np.array_equal(p_grads[k], got_grads[k]), k
    for k in p_state:
        assert np.array_equal(p_state[k], got_state[k]), k


BATCH, FRAMES, SIZE, QUEUE, EMBED, STEPS = 8, 2, 32, 32, 16, 1
METRICS = ("loss/total_loss", "nce_accuracy", "softmax_weight", "cosine_sim",
           "cosine_sim_neg_max")
SOURCE = dict(name="YT", batch_size=BATCH, num_frames=FRAMES, source_id=1)
COMMON = dict(backbone="ResNet18", embed_size=EMBED, image_size=SIZE, queue_size=QUEUE,
              temperature=0.07, momentum=0.999, shuffle_bn=True, bn_fold="expand", remat=True)


def _numpy_state(state):
    return dict(
        model={k: v.detach().numpy().copy() for k, v in state.model.state_dict().items()},
        key_model={k: v.detach().numpy().copy() for k, v in state.key_model.state_dict().items()},
        momentum={k: state.optimizer.state[p]["momentum_buffer"].numpy().copy()
                  for k, p in state.model.named_parameters()},
        queue=state.queue.vectors.numpy().copy())


@pytest.fixture(scope="module")
def steps():
    """``STEPS`` steps of JAX's ResNet18 with remat, and of the port's with
    and without remat from JAX's initial state."""
    rng = np.random.RandomState(0)
    images = [(rng.randn(BATCH, SIZE, SIZE, 3).astype(np.float32),
               rng.randn(BATCH, SIZE, SIZE, 3).astype(np.float32)) for _ in range(STEPS)]
    perm = np.random.RandomState(1).permutation(BATCH)
    mp = pytest.MonkeyPatch()
    mp.setattr(jvs, "_augment_sources",
               lambda cfg, batch, rng, d_idx, mode="train": (batch[0]["data"],
                                                             batch[0]["queue_data"]))
    mp.setattr(jvs, "make_shuffle_perm", lambda rng, n: jnp.asarray(perm))
    mp.setattr(tvs, "_augment_sources",
               lambda cfg, batch, draws: (batch[0]["data"], batch[0]["queue_data"]))
    mp.setattr(tvs, "make_shuffle_perm", lambda gen, n: torch.from_numpy(perm))
    try:
        cfg_j = jvs.VinceConfig(sources=(jvs.SourceSpec(**SOURCE),), compute_dtype=jnp.float32,
                                stem_kind="s2d", **COMMON)
        opt_j = jvs.build_vince_optimizer(0.05)
        mesh = make_mesh(MeshSpec(data_axis_size=1, queue_axis_size=1))
        state_j = jvs.shard_state(
            jax.jit(lambda key: jvs.init_vince_state(key, cfg_j, opt_j))(jax.random.PRNGKey(0)),
            mesh)
        step_j = jax.jit(jvs.make_train_step_fn(cfg_j, opt_j, mesh))
        out = {"init": None, "jax": [], "remat": [], "plain": []}
        states = {}
        for remat in (True, False):
            cfg_t = tvs.VinceConfig(sources=(tvs.SourceSpec(**SOURCE),),
                                    **{**COMMON, "remat": remat})
            opt_t = tvs.build_vince_optimizer(0.05)
            state = tvs.init_vince_state(0, cfg_t, opt_t, device="cpu")
            load_jax_state(state, jax.tree_util.tree_map(np.asarray, jax.device_get(state_j)))
            states["remat" if remat else "plain"] = (state, tvs.make_train_step_fn(cfg_t, opt_t))
        out["init"] = _numpy_state(states["remat"][0])["model"]
        for q_img, k_img in images:
            state_j, m_j = step_j(state_j, ({"data": jnp.asarray(q_img),
                                             "queue_data": jnp.asarray(k_img)},),
                                  jax.random.PRNGKey(1))
            sj = jax.device_get(state_j)
            out["jax"].append(dict(
                metrics={k: float(m_j[k]) for k in METRICS},
                model=flax_to_state_dict(sj.params, sj.batch_stats),
                key_model=flax_to_state_dict({**sj.params, **sj.key_params},
                                             sj.key_batch_stats),
                momentum=flax_to_state_dict(jax.tree_util.tree_map(
                    np.asarray, _find_trace(sj.opt_state)), {}),
                queue=np.asarray(sj.queue.vectors)))
            for name, (state, step) in states.items():
                _, m_t = step(state, ({"data": torch.from_numpy(q_img),
                                       "queue_data": torch.from_numpy(k_img)},), 0)
                out[name].append(dict(metrics={k: float(m_t[k]) for k in METRICS},
                                      **_numpy_state(state)))
        return out
    finally:
        mp.undo()


@pytest.mark.parametrize("step", range(STEPS))
def test_remat_step_matches_jax(steps, step):
    """The tolerances of ``test_torch_port_step.py``: metrics 1e-4; weights
    and statistics of both encoders 1e-4 relative with 5e-4 absolute, each
    tensor's change to 5% in norm; momentum traces 5% in norm; queue 1e-4."""
    got, ref, init = steps["remat"][step], steps["jax"][step], steps["init"]
    for k in METRICS:
        np.testing.assert_allclose(got["metrics"][k], ref["metrics"][k], rtol=1e-4, atol=1e-6,
                                   err_msg=k)
    for which in ("model", "key_model"):
        assert set(got[which]) == set(ref[which])
        for k, v in ref[which].items():
            np.testing.assert_allclose(got[which][k], v, rtol=1e-4, atol=5e-4, err_msg=k)
            if which == "model":
                d_got, d_ref = got[which][k] - init[k], v - init[k]
                assert np.linalg.norm(d_got - d_ref) <= 5e-2 * np.linalg.norm(d_ref) + 1e-7, k
    for k, v in ref["momentum"].items():
        assert np.linalg.norm(got["momentum"][k] - v) <= 5e-2 * np.linalg.norm(v) + 1e-5, k
    np.testing.assert_allclose(got["queue"], ref["queue"], rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("step", range(STEPS))
def test_remat_step_equals_the_step_without_remat(steps, step):
    got, ref = steps["remat"][step], steps["plain"][step]
    assert got["metrics"] == ref["metrics"]
    for which in ("model", "key_model", "momentum"):
        for k, v in ref[which].items():
            assert np.array_equal(got[which][k], v), (which, k)
    assert np.array_equal(got["queue"], ref["queue"])
