"""The port's ResNet and VinceEncoder against ``vince_tpu.models``: a narrow
bottleneck ResNet with the fold kernel on (forward, grads, BN running stats),
and the weight names against the JAX package's torch exporter."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vince_tpu.models.resnet import Bottleneck as JaxBottleneck
from vince_tpu.models.resnet import ResNet as JaxResNet
from vince_tpu.models.vince_model import VinceEncoder as JaxVinceEncoder
from vince_tpu.utils.torch_export import export_vince_state_dict
from vince_tpu_torch.models.resnet import Bottleneck, ResNet
from vince_tpu_torch.models.vince_model import VinceEncoder
from vince_tpu_torch.ops.kernels.folded_dot_kernel import affine_relu_dot_moments
from vince_tpu_torch.utils.jax_weights import (
    flax_to_state_dict, load_jax_variables, to_reference_name)
from torch_port_threads import one_intra_op_thread  # noqa: F401  (a module fixture)


def _perturb_scales(tree, rng):
    """BN scales 1 ± 0.5 (bn3 starts at 0, which would cut every main branch
    out of the gradient)."""
    return {k: _perturb_scales(v, rng) if isinstance(v, dict) else
            (v + 0.5 * rng.randn(*v.shape).astype(np.float32) if k == "scale" else v)
            for k, v in tree.items()}


def _backbone_arrays(tree, stats):
    """flax ResNet trees → the port ResNet's state-dict names."""
    arrays = flax_to_state_dict({"backbone": tree}, {"backbone": stats})
    return {k[len("backbone."):]: v for k, v in arrays.items()}


@pytest.fixture(scope="module")
def narrow_resnet():
    """stage_sizes [1,1,1,1], 32 filters, 8 images of 64x64: one K2 site
    (stage 3: M=128, C=128, F=512)."""
    x = np.random.RandomState(0).rand(8, 64, 64, 3).astype(np.float32)
    jm = JaxResNet(stage_sizes=[1, 1, 1, 1], block_cls=JaxBottleneck, num_filters=32,
                   bn_fold="expand", fold_kernel=True)
    variables = jax.device_get(jax.jit(jm.init)({"params": jax.random.PRNGKey(0)},
                                                jnp.asarray(x)))
    variables = {"params": _perturb_scales(variables["params"], np.random.RandomState(3)),
                 "batch_stats": variables["batch_stats"]}

    def loss(p):
        o, mut = jm.apply({"params": p, "batch_stats": variables["batch_stats"]},
                          jnp.asarray(x), train=True, mutable=["batch_stats"])
        return jnp.sum(o ** 2) * 1e-3, (o, mut["batch_stats"])

    (_, (out, stats)), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        variables["params"])
    # eval mode reads the running statistics that the train pass updated
    out_eval = jax.jit(functools.partial(jm.apply, train=False))(
        {"params": variables["params"], "batch_stats": stats}, jnp.asarray(x))

    tm = ResNet([1, 1, 1, 1], Bottleneck, num_filters=32, bn_fold="expand", fold_kernel=True)
    tm.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in
                        _backbone_arrays(variables["params"], variables["batch_stats"]).items()})
    before = affine_relu_dot_moments.plain_calls
    o_t = tm.train()(torch.from_numpy(x))
    k2_calls = affine_relu_dot_moments.plain_calls - before
    ((o_t ** 2).sum() * 1e-3).backward()
    with torch.no_grad():
        o_eval_t = tm.eval()(torch.from_numpy(x))
    return dict(out=(o_t.detach().numpy(), np.asarray(out)),
                out_eval=(o_eval_t.numpy(), np.asarray(out_eval)),
                grads=({k: p.grad.numpy() for k, p in tm.named_parameters()},
                       _backbone_arrays(jax.device_get(grads), {})),
                stats=(tm.state_dict(), _backbone_arrays(variables["params"],
                                                         jax.device_get(stats))),
                k2_calls=k2_calls)


def test_narrow_resnet_forward_train(narrow_resnet):
    got, ref = narrow_resnet["out"]
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=2e-5 * np.abs(ref).max())
    assert narrow_resnet["k2_calls"] == 1


def test_narrow_resnet_forward_eval(narrow_resnet):
    got, ref = narrow_resnet["out_eval"]
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=2e-5 * np.abs(ref).max())


def test_narrow_resnet_grads(narrow_resnet):
    """Per tensor, |g_port − g_jax| ≤ 2e-2·|g_jax| in norm (1e-2 at worst,
    on a BN bias whose gradient is a sum that cancels)."""
    got, ref = narrow_resnet["grads"]
    assert set(got) == set(ref)
    for k in got:
        assert np.linalg.norm(got[k] - ref[k]) <= 2e-2 * np.linalg.norm(ref[k]) + 1e-9, k
        assert np.linalg.norm(ref[k]) > 0, k  # every branch carries gradient


def test_narrow_resnet_running_stats(narrow_resnet):
    got, ref = narrow_resnet["stats"]
    names = [k for k in ref if k.endswith(("running_mean", "running_var"))]
    assert len(names) == 2 * sum(1 for k in got if k.endswith("running_var"))
    for k in names:
        np.testing.assert_allclose(got[k].numpy(), ref[k], rtol=1e-4, atol=1e-6, err_msg=k)


def test_weight_names_match_the_jax_exporter():
    """Every loaded tensor equals the JAX package's reference-format export
    under the mapped name, and the mapping covers the whole export."""
    jm = JaxVinceEncoder(backbone_name="ResNet50", embed_size=128, bn_fold="expand")
    variables = jax.device_get(jax.jit(jm.init)({"params": jax.random.PRNGKey(0)},
                                                jnp.zeros((2, 32, 32, 3))))
    params, stats = variables["params"], variables["batch_stats"]
    exported = export_vince_state_dict(params, stats)
    model = VinceEncoder("ResNet50", 128, bn_fold="expand")
    load_jax_variables(model, params, stats)
    loaded = model.state_dict()
    assert {to_reference_name(k) for k in loaded} == {
        k for k in exported if not k.endswith("num_batches_tracked")}
    for k, v in loaded.items():
        np.testing.assert_array_equal(v.numpy(), exported[to_reference_name(k)], err_msg=k)


def test_bottleneck_wider_than_1024_takes_the_fused_path():
    """C = 1152 (stage 4 of a ResNet50 of four times the width has C = 2048):
    the JAX block runs its fused kernel path, and so does the port's, whose
    site rule now admits what the JAX rule admits: K2 is called once (its
    plain version, on the CPU). Output to 1e-4 relative plus 2e-5 of the
    largest entry, as the narrow ResNet above."""
    import flax.linen as fnn
    from vince_tpu.models.resnet import FoldCfg
    from vince_tpu.models.resnet import _kernel_site_supported as jax_site_supported
    from vince_tpu_torch.models.resnet import _kernel_site_supported

    cin, filters = 64, 1152
    x = np.random.RandomState(4).rand(2, 8, 8, cin).astype(np.float32)
    jm = JaxBottleneck(
        filters=filters, downsample=True,
        norm=functools.partial(fnn.BatchNorm, use_running_average=False, momentum=0.9,
                               epsilon=1e-5),
        fold_cfg=FoldCfg(train=True, momentum=0.9, epsilon=1e-5, dtype=jnp.float32,
                         axis_name=None, use_kernel=True))
    variables = jax.device_get(jax.jit(jm.init)({"params": jax.random.PRNGKey(0)},
                                                jnp.asarray(x)))
    params = _perturb_scales(variables["params"], np.random.RandomState(5))
    out, mut = jax.jit(functools.partial(jm.apply, mutable=["batch_stats"]))(
        {"params": params, "batch_stats": variables["batch_stats"]}, jnp.asarray(x))
    out = np.asarray(out)

    tm = Bottleneck(cin, filters, downsample=True, fold=True, fold_kernel=True)
    arrays = flax_to_state_dict({"backbone": {"layer1_0": params}},
                                {"backbone": {"layer1_0": variables["batch_stats"]}})
    tm.load_state_dict({k[len("backbone.layer1.0."):]: torch.from_numpy(np.array(v))
                        for k, v in arrays.items()})
    for c in (filters, 2048, 1024):
        assert _kernel_site_supported(torch.empty(2, 8, 8, c), 4 * c)
        assert jax_site_supported(jnp.zeros((2, 8, 8, c)), 4 * c)
    before = affine_relu_dot_moments.plain_calls
    with torch.no_grad():
        got = tm.train()(torch.from_numpy(x)).numpy()
    assert affine_relu_dot_moments.plain_calls == before + 1  # the fused path
    np.testing.assert_allclose(got, out, rtol=1e-4, atol=2e-5 * np.abs(out).max())
    ref_stats = flax_to_state_dict({"backbone": {"layer1_0": params}},
                                   {"backbone": {"layer1_0": jax.device_get(mut["batch_stats"])}})
    for k, v in ref_stats.items():
        if k.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(tm.state_dict()[k[len("backbone.layer1.0."):]].numpy(), v,
                                       rtol=1e-4, atol=1e-6, err_msg=k)
