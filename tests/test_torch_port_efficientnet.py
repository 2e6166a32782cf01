"""The port's EfficientNet against ``vince_tpu.models.efficientnet``: the B0
forward in train and eval mode with the running statistics, over every
``bn_fold`` × ``dw_kind`` × ``se_kind``. float32 on the CPU, weights carried by
``flax_to_state_dict``. TensorFlow's asymmetric SAME padding at 224×224, the
B1-B4 shapes and the weight names against the JAX package's torch exporter
are in ``test_torch_port_efficientnet_shapes.py``, which shares this file's
helpers."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_threads import one_intra_op_thread  # noqa: F401  (a module fixture)
from vince_tpu.models.efficientnet import EfficientNet as JaxEfficientNet
from vince_tpu_torch.models.efficientnet import EfficientNet
from vince_tpu_torch.ops.kernels.depthwise_kernel import depthwise_conv
from vince_tpu_torch.utils.jax_weights import flax_to_state_dict

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
