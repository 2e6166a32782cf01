"""The port's EfficientNet against ``vince_tpu.models.efficientnet``: the B0
forward in train and eval mode with the running statistics, over every
``bn_fold`` × ``dw_kind`` × ``se_kind``; TensorFlow's asymmetric SAME padding at
224×224; the B1-B4 shapes; and the weight names against the JAX package's
torch exporter. float32 on the CPU, weights carried by ``flax_to_state_dict``."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vince_tpu.models.efficientnet import EfficientNet as JaxEfficientNet
from vince_tpu.models.vince_model import VinceEncoder as JaxVinceEncoder
from vince_tpu.utils.torch_export import export_vince_state_dict
from vince_tpu_torch.models.efficientnet import EfficientNet, round_filters, round_repeats
from vince_tpu_torch.models.vince_model import VinceEncoder
from vince_tpu_torch.ops.kernels.depthwise_kernel import depthwise_conv
from vince_tpu_torch.utils.jax_weights import (
    flax_to_state_dict, load_jax_variables, to_reference_name)

# the JAX emission each of the port's stands against: on the CPU the JAX
# "pallas" kind itself runs the grouped convolution
JAX_DW_KIND = {"conv": "conv", "tap": "tap", "kernel": "conv"}


def _random_like(shapes, seed):
    """A tree of random arrays in the shapes of ``jax.eval_shape``'s result:
    scales near 1, variances positive, everything else small."""
    rng = np.random.RandomState(seed)

    def leaf(path, s):
        name = path[-1].key
        x = rng.randn(*s.shape).astype(np.float32)
        if name in ("scale", "var"):
            return 1.0 + 0.3 * np.abs(x)
        if name == "kernel":
            return x / np.sqrt(max(1, int(np.prod(s.shape[:-1]))))
        return 0.1 * x

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _backbone_arrays(params, stats):
    arrays = flax_to_state_dict({"backbone": params}, {"backbone": stats})
    return {k[len("backbone."):]: v for k, v in arrays.items()}


@pytest.fixture(scope="module")
def b0_variables():
    shapes = jax.eval_shape(JaxEfficientNet(variant="b0").init,
                            {"params": jax.random.PRNGKey(0)}, jnp.zeros((2, 64, 64, 3)))
    return _random_like(shapes, 0)


@functools.lru_cache(maxsize=None)
def _images(n, size):
    return np.random.RandomState(n * 1000 + size).rand(n, size, size, 3).astype(np.float32)


_JAX_RUNS = {}


def _jax_run(variables, bn_fold, dw_kind, se_kind, n, size):
    """(train output, statistics after it, eval output with those statistics)."""
    key = (bn_fold, dw_kind, se_kind, n, size)
    if key not in _JAX_RUNS:
        jm = JaxEfficientNet(variant="b0", bn_fold=bn_fold, dw_kind=dw_kind, se_kind=se_kind)
        x = jnp.asarray(_images(n, size))
        out, mut = jax.jit(functools.partial(jm.apply, train=True, mutable=["batch_stats"]))(
            variables, x)
        out_eval = jax.jit(functools.partial(jm.apply, train=False))(
            {"params": variables["params"], "batch_stats": mut["batch_stats"]}, x)
        _JAX_RUNS[key] = (np.asarray(out), jax.device_get(mut["batch_stats"]),
                          np.asarray(out_eval))
    return _JAX_RUNS[key]


def _port_model(variables, **kwargs):
    tm = EfficientNet("b0", **kwargs)
    tm.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in _backbone_arrays(
        variables["params"], variables["batch_stats"]).items()}, strict=True)
    return tm


@pytest.mark.parametrize("se_kind", ["mul", "fold"])
@pytest.mark.parametrize("dw_kind", ["conv", "tap", "kernel"])
@pytest.mark.parametrize("bn_fold", ["none", "expand"])
def test_b0_forward_and_running_stats(b0_variables, bn_fold, dw_kind, se_kind):
    """4 images of 64×64. Outputs to 1e-4 relative plus 2e-5 of the largest
    entry (16 blocks of f32 sums in another order), 1e-4 with the fold, whose
    E[y²]−μ² magnifies the order of summation (the last blocks normalise over
    16 positions); running statistics to 1e-4."""
    atol = 1e-4 if bn_fold == "expand" else 2e-5
    ref_train, ref_stats, ref_eval = _jax_run(b0_variables, bn_fold, JAX_DW_KIND[dw_kind],
                                              se_kind, 4, 64)
    tm = _port_model(b0_variables, bn_fold=bn_fold, dw_kind=dw_kind, se_kind=se_kind)
    x = torch.from_numpy(_images(4, 64))
    before = depthwise_conv.plain_calls
    with torch.no_grad():
        out = tm.train()(x).numpy()
    # at 64×64 five stride-1 sites are at least as large as their filter
    # (blocks 0, 2, 4, 6, 7); the 4×4 and 2×2 sites with k=5 or 2×2 with k=3 are not
    assert depthwise_conv.plain_calls - before == (5 if dw_kind == "kernel" else 0)
    assert out.shape == ref_train.shape == (4, 2, 2, 1280)
    np.testing.assert_allclose(out, ref_train, rtol=1e-4, atol=atol * np.abs(ref_train).max())
    got, ref = tm.state_dict(), _backbone_arrays(b0_variables["params"], ref_stats)
    names = [k for k in ref if k.endswith(("running_mean", "running_var"))]
    assert len(names) == 2 * 49  # stem, head, 3 per block less block_0's expand
    for k in names:
        np.testing.assert_allclose(got[k].numpy(), ref[k], rtol=1e-4, atol=1e-6, err_msg=k)
    with torch.no_grad():
        out_eval = tm.eval()(x).numpy()
    np.testing.assert_allclose(out_eval, ref_eval, rtol=1e-4, atol=atol * np.abs(ref_eval).max())


def test_b0_at_224_pads_asymmetrically_and_runs_twelve_kernel_sites(b0_variables):
    """One 224×224 image: every stride-2 site has an even input, so SAME pads
    (0, 1) for k=3 and (1, 2) for k=5, not both sides alike; and all 12
    stride-1 depthwise sites go through K4's wrapper."""
    ref_train, _, _ = _jax_run(b0_variables, "expand", "conv", "mul", 1, 224)
    tm = _port_model(b0_variables, bn_fold="expand", dw_kind="kernel")
    before = depthwise_conv.plain_calls
    with torch.no_grad():
        out = tm.train()(torch.from_numpy(_images(1, 224))).numpy()
    assert depthwise_conv.plain_calls - before == 12
    assert out.shape == (1, 7, 7, 1280)
    np.testing.assert_allclose(out, ref_train, rtol=1e-4, atol=2e-5 * np.abs(ref_train).max())


def test_symmetric_padding_would_differ():
    """The stem on an even input: SAME's (0, 1) padding is not conv2d's (1, 1)."""
    from vince_tpu_torch.models.efficientnet import StemConv

    stem = StemConv(3, 8)
    stem.reset_parameters(torch.Generator().manual_seed(0))
    x = torch.from_numpy(_images(1, 8))
    y = stem(x)
    sym = torch.nn.functional.conv2d(x.permute(0, 3, 1, 2), stem.weight, stride=2,
                                     padding=1).permute(0, 2, 3, 1)
    assert y.shape == sym.shape == (1, 4, 4, 8)
    assert not torch.allclose(y, sym, atol=1e-3)
    ref = jax.lax.conv_general_dilated(
        jnp.asarray(x.numpy()), jnp.asarray(stem.weight.detach().permute(2, 3, 1, 0).numpy()),
        (2, 2), "SAME", dimension_numbers=("NHWC", "HWIO", "NHWC"))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(ref), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("variant,head,blocks", [
    ("b1", 1280, 23), ("b2", 1408, 23), ("b3", 1536, 26), ("b4", 1792, 32)])
def test_scaled_variants_match_jax_shapes(variant, head, blocks):
    """Every parameter and buffer of B1-B4 has the JAX tree's name and shape."""
    jm = JaxEfficientNet(variant=variant)
    shapes = jax.eval_shape(jm.init, {"params": jax.random.PRNGKey(0)},
                            jnp.zeros((1, 32, 32, 3)))
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), shapes)
    ref = _backbone_arrays(zeros["params"], zeros["batch_stats"])
    tm = EfficientNet(variant)
    got = tm.state_dict()
    assert {k: tuple(v.shape) for k, v in got.items()} == {k: v.shape for k, v in ref.items()}
    assert tm.output_channels == jm.output_channels == head
    assert len(tm._blocks) == blocks


def test_rounding_rules():
    assert [round_filters(c, 1.4) for c in (32, 16, 24, 40, 80, 112, 192, 320, 1280)] == [
        48, 24, 32, 56, 112, 160, 272, 448, 1792]
    assert [round_repeats(r, 1.8) for r in (1, 2, 3, 4)] == [2, 4, 6, 8]


def test_weight_names_match_the_jax_exporter():
    """Every loaded tensor equals the JAX package's reference-format export
    under the mapped name, and the mapping covers the whole export."""
    jm = JaxVinceEncoder(backbone_name="EfficientNetB0", embed_size=128)
    shapes = jax.eval_shape(jm.init, {"params": jax.random.PRNGKey(0)},
                            jnp.zeros((2, 32, 32, 3)))
    variables = _random_like(shapes, 1)
    params, stats = variables["params"], variables["batch_stats"]
    exported = export_vince_state_dict(params, stats)
    model = VinceEncoder("EfficientNetB0", 128)
    load_jax_variables(model, params, stats)
    loaded = model.state_dict()
    assert {to_reference_name(k) for k in loaded} == {
        k for k in exported if not k.endswith("num_batches_tracked")}
    for k, v in loaded.items():
        np.testing.assert_array_equal(v.numpy(), exported[to_reference_name(k)], err_msg=k)


def test_encoder_passes_backbone_options():
    """``dw_kind`` and ``se_kind`` reach an EfficientNet only, ``fold_kernel`` a ResNet only."""
    enc = VinceEncoder("EfficientNetB0", 16, bn_fold="expand", fold_kernel=True,
                       dw_kind="kernel", se_kind="fold")
    assert enc.backbone._blocks[3]._depthwise_conv.kind == "kernel"
    assert enc.backbone._blocks[3].se_kind == "fold" and enc.backbone._blocks[3].fold
    res = VinceEncoder("ResNet50", 16, bn_fold="expand", fold_kernel=True, dw_kind="kernel")
    assert res.backbone.layer2[0].fold_kernel
    with pytest.raises(ValueError):
        VinceEncoder("EfficientNetB0", 16, dw_kind="pallas")
