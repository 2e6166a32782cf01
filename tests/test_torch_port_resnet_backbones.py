"""The backbones the port adds to its registry against
``vince_tpu.models.resnet``: the parameter shapes of ResNet34/101/152/50w2/
50w4 and of the SiamFC-dilated ResNet18/50 (from ``jax.eval_shape`` of the
flax init, nothing compiled), and the
train-mode forward and running statistics of ResNet34 and ResNet50w2 at
32x32 (8 images: stage 4's BatchNorm then normalises 8 values a channel;
with 2 it magnifies the order of summation past the bound). float32 on the
CPU, to the bounds of ``test_torch_port_resnet.py``; the helpers are
``test_torch_port_resnet_options.py``'s."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_port_resnet import _backbone_arrays
from tests.test_torch_port_resnet_options import _close, _forward_pair
from vince_tpu.models import resnet as jax_resnet
from vince_tpu_torch.models import backbones
from torch_port_threads import one_intra_op_thread  # noqa: F401  (a module fixture)


@pytest.mark.parametrize("name", ["ResNet34", "ResNet101", "ResNet152", "ResNet50w2",
                                  "ResNet50w4", "ResNet18SiamFCDilated",
                                  "ResNet50SiamFCDilated"])
def test_backbone_parameter_shapes_match_jax(name):
    """Every parameter and statistic of the registry entry, by name and
    shape, and the output width."""
    jm = getattr(jax_resnet, name)(bn_fold="expand")
    shapes = jax.eval_shape(jm.init, {"params": jax.random.PRNGKey(0)},
                            jnp.zeros((1, 32, 32, 3)))
    # zero-stride views carry the shapes through the weight mapping
    views = jax.tree_util.tree_map(lambda s: np.broadcast_to(np.float32(0), s.shape), shapes)
    ref = {k: v.shape for k, v in _backbone_arrays(views["params"],
                                                   views["batch_stats"]).items()}
    with torch.device("meta"):
        tm = backbones.get_backbone(name)(bn_fold="expand")
    got = {k: tuple(v.shape) for k, v in tm.state_dict().items()}
    assert got == ref
    assert tm.output_channels == jm.output_channels


# ResNet50w2's 3x3 convolutions sum up to 9216 f32 products (in another order
# than XLA's) through 16 blocks: 1.9e-4 of the largest entry at worst at
# these shapes, with bn_fold "none" or "expand"; ResNet34 stays within 2e-5
@pytest.mark.parametrize("name,atol_frac", [("ResNet34", 2e-5), ("ResNet50w2", 5e-4)])
def test_backbone_forward_matches_jax(name, atol_frac):
    x = np.random.RandomState(0).rand(8, 32, 32, 3).astype(np.float32)
    jm = getattr(jax_resnet, name)(bn_fold="expand", stem_kind="s2d")
    tm = backbones.get_backbone(name)(bn_fold="expand", stem_kind="s2d")
    _, _, ref, stats = _forward_pair(jm, tm, x)
    with torch.no_grad():
        got = tm.train()(torch.from_numpy(x)).numpy()
    assert got.shape == ref.shape == (8, 1, 1, jm.output_channels)
    _close(got, ref, atol_frac)
    ref_stats = _backbone_arrays({}, stats)
    for k, v in ref_stats.items():
        np.testing.assert_allclose(tm.state_dict()[k].numpy(), v, rtol=1e-4, atol=1e-6,
                                   err_msg=k)


