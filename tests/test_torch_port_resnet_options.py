"""The ResNet options of the port against ``vince_tpu.models.resnet``: the
conv7 stem (float32, and its arithmetic beside s2d's under bf16), groupnorm
(forward and gradients, with ``bn_fold`` asked and ignored), and
``bn_fold="all"`` (forward, gradients, running statistics). float32 on the
CPU unless a test says otherwise, to the bounds of
``test_torch_port_resnet.py``. The new backbones are in
``test_torch_port_resnet_backbones.py``."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_port_resnet import _backbone_arrays, _perturb_scales
from vince_tpu.models import resnet as jax_resnet
from vince_tpu.models.resnet import Bottleneck as JaxBottleneck
from vince_tpu.models.resnet import ResNet as JaxResNet
from vince_tpu_torch.models import backbones
from vince_tpu_torch.models.resnet import Bottleneck, ResNet
from vince_tpu_torch.ops.kernels.folded_dot_kernel import affine_relu_dot_moments
from torch_port_threads import one_intra_op_thread  # noqa: F401  (a module fixture)


def _forward_pair(jm, tm, x, perturb=True):
    """Train-mode forward of both from the flax init (BN/GN scales moved off
    1 and 0), the port loaded with the flax weights."""
    variables = jax.device_get(jax.jit(jm.init)({"params": jax.random.PRNGKey(0)},
                                                jnp.asarray(x)))
    params = variables["params"]
    if perturb:
        params = _perturb_scales(params, np.random.RandomState(3))
    stats = variables.get("batch_stats", {})
    out, mut = jax.jit(functools.partial(jm.apply, mutable=["batch_stats"]))(
        {"params": params, "batch_stats": stats}, jnp.asarray(x))
    tm.load_state_dict({k: torch.from_numpy(np.array(v))
                        for k, v in _backbone_arrays(params, stats).items()})
    return params, stats, np.asarray(out), jax.device_get(mut.get("batch_stats", {}))


def _close(got, ref, atol_frac=2e-5):
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=atol_frac * np.abs(ref).max())


def test_conv7_stem_matches_jax():
    """A ResNet18 with the conv7 stem in float32."""
    x = np.random.RandomState(1).rand(8, 32, 32, 3).astype(np.float32)
    jm = jax_resnet.ResNet18(bn_fold="expand", stem_kind="conv7")
    tm = backbones.get_backbone("ResNet18")(bn_fold="expand", stem_kind="conv7")
    _, _, ref, _ = _forward_pair(jm, tm, x)
    with torch.no_grad():
        _close(tm.train()(torch.from_numpy(x)).numpy(), ref)


@pytest.mark.parametrize("stem_kind", ["conv7", "s2d"])
def test_stem_arithmetic_under_bf16(stem_kind):
    """The stem (no stages: conv, BN, ReLU, max pool) with bf16 compute: conv7
    convolves in float32, as flax promotes the bf16 images to the f32 filter,
    s2d in bf16; both hand bf16 to the stages. Each agrees with JAX's to two
    bf16 roundings (s2d's convolution rounds to bf16 before the BatchNorm,
    whose statistics sum in another order)."""
    x = np.random.RandomState(2).rand(2, 32, 32, 3).astype(np.float32)
    jm = JaxResNet(stage_sizes=[], block_cls=JaxBottleneck, stem_kind=stem_kind,
                   dtype=jnp.bfloat16)
    tm = ResNet([], Bottleneck, stem_kind=stem_kind, dtype=torch.bfloat16)
    _, _, ref, _ = _forward_pair(jm, tm, x)
    with torch.no_grad():
        got = tm.train()(torch.from_numpy(x))
        conv = tm.conv1(torch.from_numpy(x).bfloat16())
    assert got.dtype == torch.bfloat16 and ref.dtype == jnp.bfloat16
    assert conv.dtype == (torch.float32 if stem_kind == "conv7" else torch.bfloat16)
    ref = ref.astype(np.float32)
    np.testing.assert_allclose(got.float().numpy(), ref, rtol=1.6e-2, atol=1e-2)


@pytest.fixture(scope="module")
def groupnorm():
    """ResNet18 with groupnorm (bn_fold="expand" asked, and ignored): output
    and parameter gradients of a train-mode forward."""
    x = np.random.RandomState(4).rand(8, 32, 32, 3).astype(np.float32)
    jm = jax_resnet.ResNet18(norm_kind="groupnorm", bn_fold="expand", stem_kind="s2d")
    tm = backbones.get_backbone("ResNet18")(norm_kind="groupnorm", bn_fold="expand",
                                            stem_kind="s2d")
    params, _, ref, stats = _forward_pair(jm, tm, x)

    def loss(p):
        return jnp.sum(jm.apply({"params": p}, jnp.asarray(x)) ** 2) * 1e-3

    grads = jax.device_get(jax.jit(jax.grad(loss))(params))
    out = tm.train()(torch.from_numpy(x))
    ((out ** 2).sum() * 1e-3).backward()
    return dict(out=(out.detach().numpy(), ref), stats=stats, model=tm,
                grads=({k: p.grad.numpy() for k, p in tm.named_parameters()},
                       _backbone_arrays(grads, {})))


def test_groupnorm_forward_matches_jax(groupnorm):
    got, ref = groupnorm["out"]
    _close(got, ref)
    assert groupnorm["stats"] == {}
    assert not any(k.endswith("running_mean") for k in groupnorm["model"].state_dict())
    assert not any(b.fold for b in groupnorm["model"].modules() if hasattr(b, "fold"))


def test_groupnorm_grads_match_jax(groupnorm):
    """Per tensor, |g_port − g_jax| ≤ 2e-2·|g_jax| in norm, as the narrow
    ResNet's gradients in ``test_torch_port_resnet.py``."""
    got, ref = groupnorm["grads"]
    assert set(got) == set(ref)
    for k in got:
        assert np.linalg.norm(got[k] - ref[k]) <= 2e-2 * np.linalg.norm(ref[k]) + 1e-9, k


@pytest.fixture(scope="module")
def fold_all():
    """stage_sizes [1,1,1,1], 32 filters, 8 images of 64x64, bn_fold="all"
    with the fold kernel: conv1 of every bottleneck folded too, and K2 at
    stage 3, as ``test_torch_port_resnet.py``'s narrow ResNet."""
    x = np.random.RandomState(0).rand(8, 64, 64, 3).astype(np.float32)
    jm = JaxResNet(stage_sizes=[1, 1, 1, 1], block_cls=JaxBottleneck, num_filters=32,
                   bn_fold="all", fold_kernel=True)
    tm = ResNet([1, 1, 1, 1], Bottleneck, num_filters=32, bn_fold="all", fold_kernel=True)
    params, stats, _, _ = _forward_pair(jm, tm, x)

    def loss(p):
        o, mut = jm.apply({"params": p, "batch_stats": stats}, jnp.asarray(x), train=True,
                          mutable=["batch_stats"])
        return jnp.sum(o ** 2) * 1e-3, (o, mut["batch_stats"])

    (_, (out, new_stats)), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
    before = affine_relu_dot_moments.plain_calls
    o_t = tm.train()(torch.from_numpy(x))
    k2_calls = affine_relu_dot_moments.plain_calls - before
    ((o_t ** 2).sum() * 1e-3).backward()
    return dict(out=(o_t.detach().numpy(), np.asarray(out)), k2_calls=k2_calls, model=tm,
                grads=({k: p.grad.numpy() for k, p in tm.named_parameters()},
                       _backbone_arrays(jax.device_get(grads), {})),
                stats=(tm.state_dict(), _backbone_arrays(params, jax.device_get(new_stats))))


def test_fold_all_forward(fold_all):
    got, ref = fold_all["out"]
    _close(got, ref)
    assert fold_all["k2_calls"] == 1
    assert all(b.fold_all for b in fold_all["model"].modules() if isinstance(b, Bottleneck))


def test_fold_all_grads(fold_all):
    got, ref = fold_all["grads"]
    assert set(got) == set(ref)
    for k in got:
        assert np.linalg.norm(got[k] - ref[k]) <= 2e-2 * np.linalg.norm(ref[k]) + 1e-9, k
        assert np.linalg.norm(ref[k]) > 0, k


def test_fold_all_running_stats(fold_all):
    got, ref = fold_all["stats"]
    for k in ref:
        if k.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(got[k].numpy(), ref[k], rtol=1e-4, atol=1e-6, err_msg=k)
