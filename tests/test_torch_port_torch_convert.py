"""The port's conversion of the reference's PyTorch weights
(``vince_tpu_torch/utils/torch_convert.py``) against ``vince_tpu``'s, the
three cases of ``tests/test_torch_convert.py``: a torchvision ResNet18, a
whole reference ``VinceModel`` (ResNet18 under the DataParallel prefixes,
the projection, the ImageNet decoders, the jigsaw head and the attention
pool) and an EfficientNet-B0 backbone with its projection. One seeded state
dict each goes through JAX's ``convert_*`` and ``utils/jax_weights.py``, and
through the port's converter: the tensors must be equal, and the eval-mode
forwards of both packages' models agree at 1e-5. Beside them: the keys each
side drops and the keys on which both raise."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vince_tpu.models import resnet as jresnet
from vince_tpu.models.vince_model import VinceEncoder as JaxVinceEncoder
from vince_tpu.utils import torch_convert as jconv
from vince_tpu_torch.models.resnet import ResNet18
from vince_tpu_torch.models.vince_model import VinceEncoder
from vince_tpu_torch.utils import torch_convert as tconv
from vince_tpu_torch.utils.jax_weights import flax_to_state_dict
from torch_port_threads import one_intra_op_thread  # noqa: F401  (a module fixture)

PREFIX = "feature_extractor.module.model."
TOL = dict(rtol=1e-5, atol=1e-5)


def _seeded(names_shapes, seed):
    """A reference-layout state dict of the given names and shapes: weights
    scaled by 1/sqrt(fan-in), BatchNorm scales near 1, running variances
    positive, a ``num_batches_tracked`` per BatchNorm."""
    rng = np.random.RandomState(seed)
    sd = {}
    for name, shape in names_shapes:
        leaf = name.rsplit(".", 1)[-1]
        if leaf == "running_var":
            sd[name] = (rng.rand(*shape) + 0.5).astype(np.float32)
            sd[name[:-len("running_var")] + "num_batches_tracked"] = np.int64(7)
        elif leaf == "running_mean" or (leaf == "bias"):
            sd[name] = (0.1 * rng.randn(*shape)).astype(np.float32)
        elif len(shape) == 1:  # a BatchNorm scale
            sd[name] = (1 + 0.2 * rng.randn(*shape)).astype(np.float32)
        else:
            fan_in = int(np.prod(shape[1:]))
            sd[name] = (rng.randn(*shape) / np.sqrt(fan_in)).astype(np.float32)
    return sd


def _port_layout(model):
    return [(k, tuple(v.shape)) for k, v in model.state_dict().items()]


def _images(seed=0, n=2, size=32):
    return np.random.RandomState(seed).rand(n, size, size, 3).astype(np.float32)


def _assert_same_tensors(got, ref):
    assert sorted(got) == sorted(ref), (sorted(set(got) ^ set(ref)))[:10]
    for k, v in ref.items():
        assert np.array_equal(got[k].numpy(), v), k


def _resnet18_dict(seed):
    """torchvision's ResNet18 names and shapes, with its classifier ``fc``."""
    with torch.device("meta"):
        names = _port_layout(ResNet18())
    sd = _seeded(names + [("fc.weight", (1000, 512)), ("fc.bias", (1000,))], seed)
    return sd


def test_resnet18_matches_jax():
    sd = _resnet18_dict(0)
    params, stats = jconv.convert_resnet_state_dict(sd)
    ref = {k[len("backbone."):]: v for k, v in
           flax_to_state_dict({"backbone": params}, {"backbone": stats}).items()}
    got = tconv.convert_resnet_state_dict(sd)
    _assert_same_tensors(got, ref)
    assert not any(k.startswith("fc.") or k.endswith("num_batches_tracked") for k in got)

    model = ResNet18(stem_kind="conv7").eval()
    model.load_state_dict(got, strict=True)
    x = _images()
    with torch.no_grad():
        out = model(torch.from_numpy(x)).numpy()
    ref_out = jresnet.ResNet18().apply({"params": params, "batch_stats": stats},
                                       jnp.asarray(x), train=False)
    np.testing.assert_allclose(out, np.asarray(ref_out), **TOL)


def _vince_dict(seed):
    """A reference VinceModel of a ResNet18 with every head the converter
    maps: the backbone under the DataParallel prefixes, ``embedding.{0,2}``,
    ``imagenet_decoders.{0,1.0,1.2}``, ``jigsaw_linear``,
    ``jigsaw_embedding.{0,2}`` and a 1×1 conv ``average_layers.attention``."""
    backbone = _resnet18_dict(seed)
    heads = [("embedding.0.weight", (512, 512)), ("embedding.0.bias", (512,)),
             ("embedding.2.weight", (64, 512)), ("embedding.2.bias", (64,)),
             ("imagenet_decoders.0.weight", (1000, 512)), ("imagenet_decoders.0.bias", (1000,)),
             ("imagenet_decoders.1.0.weight", (512, 512)),
             ("imagenet_decoders.1.0.bias", (512,)),
             ("imagenet_decoders.1.2.weight", (1000, 512)),
             ("imagenet_decoders.1.2.bias", (1000,)),
             ("jigsaw_linear.weight", (512, 512)), ("jigsaw_linear.bias", (512,)),
             ("jigsaw_embedding.0.weight", (512, 9 * 512)),
             ("jigsaw_embedding.0.bias", (512,)),
             ("jigsaw_embedding.2.weight", (64, 512)), ("jigsaw_embedding.2.bias", (64,)),
             ("average_layers.attention.weight", (1, 512, 1, 1)),
             ("average_layers.attention.bias", (1,))]
    sd = {PREFIX + k: v for k, v in backbone.items()}
    sd.update(_seeded(heads, seed + 1))
    return sd


@pytest.fixture(scope="module")
def vince_case():
    sd = _vince_dict(1)
    params, stats = jconv.convert_vince_state_dict(sd)
    return sd, params, stats


def test_vince_checkpoint_matches_jax(vince_case):
    sd, params, stats = vince_case
    got = tconv.convert_vince_state_dict(sd)
    _assert_same_tensors(got, flax_to_state_dict(params, stats))

    model = VinceEncoder("ResNet18", 64, use_attention=True, jigsaw=True,
                         use_imagenet_decoders=True).eval()
    loaded = tconv.load_converted(model, got)
    assert loaded == ["backbone", "embedding", "imagenet_decoder_0", "imagenet_decoder_1",
                      "jigsaw", "pool"]
    x = _images(1)
    with torch.no_grad():
        out = model(torch.from_numpy(x))
        logits = model.imagenet_logits(out["extracted_features"])
    jm = JaxVinceEncoder(backbone_name="ResNet18", embed_size=64, use_attention=True,
                         jigsaw=True, use_imagenet_decoders=True)
    variables = {"params": params, "batch_stats": stats}
    ref = jm.apply(variables, jnp.asarray(x), train=False)
    ref_logits = jm.apply(variables, ref["extracted_features"],
                          method=JaxVinceEncoder.imagenet_logits)
    for key in ("embeddings", "extracted_features", "attention_masks"):
        np.testing.assert_allclose(out[key].numpy(), np.asarray(ref[key]), **TOL, err_msg=key)
    for g, r in zip(logits, ref_logits):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), **TOL)


def test_efficientnet_backbone_matches_jax():
    """A whole EfficientNet-B0 under the prefixes, with ``_fc`` and the
    projection, as ``convert_vince_state_dict`` routes it by ``_conv_stem``."""
    with torch.device("meta"):
        model = VinceEncoder("EfficientNetB0", 64)
    layout = [(PREFIX + k[len("backbone."):], s) for k, s in _port_layout(model)
              if k.startswith("backbone.")]
    layout += [(PREFIX + "_fc.weight", (1000, 1280)), (PREFIX + "_fc.bias", (1000,)),
               ("embedding.0.weight", (1280, 1280)), ("embedding.0.bias", (1280,)),
               ("embedding.2.weight", (64, 1280)), ("embedding.2.bias", (64,))]
    sd = _seeded(layout, 2)
    params, stats = jconv.convert_vince_state_dict(sd)
    got = tconv.convert_vince_state_dict(sd)
    _assert_same_tensors(got, flax_to_state_dict(params, stats))

    model = VinceEncoder("EfficientNetB0", 64).eval()
    assert tconv.load_converted(model, got) == ["backbone", "embedding"]
    x = _images(2)
    with torch.no_grad():
        out = model(torch.from_numpy(x))["embeddings"].numpy()
    jm = JaxVinceEncoder(backbone_name="EfficientNetB0", embed_size=64)
    ref = jax.jit(functools.partial(jm.apply, train=False))(
        {"params": params, "batch_stats": stats}, jnp.asarray(x))
    np.testing.assert_allclose(out, np.asarray(ref["embeddings"]), **TOL)


@pytest.mark.parametrize("key", [PREFIX + "bn1.scale", PREFIX + "layer1.0.downsample.1.mu",
                                 PREFIX + "_blocks.0._bn3.weight",
                                 PREFIX + "_blocks.0._se_squeeze.weight"])
def test_unknown_modules_raise_where_jax_raises(key):
    sd = {key: np.ones(4, np.float32)}
    if "_blocks" in key:
        sd[PREFIX + "_conv_stem.weight"] = np.ones((32, 3, 3, 3), np.float32)
    with pytest.raises(KeyError):
        jconv.convert_vince_state_dict(sd)
    with pytest.raises(KeyError):
        tconv.convert_vince_state_dict(sd)


def test_dropped_keys_are_jax_dropped_keys(vince_case):
    """Keys JAX skips (convolution biases, an unknown downsample entry, heads
    of no known module, ``average_layers`` shapes that name no 1×1 map) are
    skipped by the port too, and a partial head loads nothing it lacks."""
    sd = dict(vince_case[0])
    sd[PREFIX + "conv1.bias"] = np.ones(64, np.float32)
    sd[PREFIX + "layer2.0.downsample.2.weight"] = np.ones(4, np.float32)
    sd["embedding.1.weight"] = np.ones(4, np.float32)
    sd["average_layers.attention.weight"] = np.ones((2, 512, 1, 1), np.float32)
    params, stats = jconv.convert_vince_state_dict(sd)
    got = tconv.convert_vince_state_dict(sd)
    _assert_same_tensors(got, flax_to_state_dict(params, stats))
    assert "pool" not in params and not any(k.startswith("pool.") for k in got)
    model = VinceEncoder("ResNet18", 64)
    del got["embedding.fc2.bias"]
    with pytest.raises(ValueError, match="embedding lacks 1 parameters"):
        tconv.load_converted(model, got)
