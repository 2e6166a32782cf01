"""The port's EfficientNet against ``vince_tpu.models.efficientnet``, beside the
B0 forward of ``test_torch_port_efficientnet.py`` (whose helpers it shares):
TensorFlow's asymmetric SAME padding at 224×224 with the 12 kernel sites, the
B1-B4 shapes, the rounding rules, the weight names against the JAX package's
torch exporter, and the encoder's backbone options. float32 on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_port_efficientnet import (  # noqa: F401  (b0_variables: a module fixture)
    _backbone_arrays, _images, _jax_run, _port_model, _random_like, b0_variables)
from torch_port_threads import one_intra_op_thread  # noqa: F401  (a module fixture)
from vince_tpu.models.efficientnet import EfficientNet as JaxEfficientNet
from vince_tpu.models.vince_model import VinceEncoder as JaxVinceEncoder
from vince_tpu.utils.torch_export import export_vince_state_dict
from vince_tpu_torch.models.efficientnet import EfficientNet, round_filters, round_repeats
from vince_tpu_torch.models.vince_model import VinceEncoder
from vince_tpu_torch.ops.kernels.depthwise_kernel import depthwise_conv
from vince_tpu_torch.utils.jax_weights import load_jax_variables, to_reference_name


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
