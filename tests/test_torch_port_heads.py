"""The port's heads and the VinceEncoder options that use them against
``vince_tpu.models``: ``AttentionPool2D``, ``JigsawHeads`` and
``MultiLayerLinear`` with carried flax weights (forward and input gradient),
``jigsaw_patchify``, a ResNet18 ``VinceEncoder`` with the attention pool, the
jigsaw head and the ImageNet decoders loaded from ``full_init``'s tree, the
EMA split, and the reference names of the heads. float32 on the CPU, to
1e-4 relative as the step tests."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vince_tpu.models import heads as jheads
from vince_tpu.models.vince_model import VinceEncoder as JaxVinceEncoder
from vince_tpu.models.vince_model import jigsaw_patchify as jax_jigsaw_patchify
from vince_tpu.models.vince_model import split_vince_params as jax_split_vince_params
from vince_tpu.utils.torch_export import export_vince_state_dict
from vince_tpu_torch.models import heads
from vince_tpu_torch.models.vince_model import (
    VinceEncoder, jigsaw_patchify, random_jigsaw_perms, split_vince_params)
from vince_tpu_torch.utils.jax_weights import (
    flax_to_state_dict, load_jax_variables, to_reference_name)
from torch_port_threads import one_intra_op_thread  # noqa: F401  (a module fixture)

RTOL, ATOL = 1e-4, 1e-6
C, EMBED, CLASSES = 32, 16, 10


def _close(got, ref, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=RTOL, atol=atol)


def _perturb(tree, rng, scale=0.1):
    """Every leaf moved off its init (the biases start at zero)."""
    return jax.tree_util.tree_map(
        lambda x: (np.asarray(x) + scale * rng.randn(*x.shape)).astype(np.float32), tree)


def _load_head(module, top, params):
    """Carry a flax head's params into the port's head ``module``."""
    arrays = flax_to_state_dict({"backbone": {}, top: params}, {})
    module.load_state_dict({k[len(top) + 1:]: torch.from_numpy(np.array(v))
                            for k, v in arrays.items()}, strict=True)
    return module


def _grad_pair(j_fn, t_fn, x, cotangents):
    """Output and input gradient of sum(out_i · cot_i) on both sides."""
    def loss(xj):
        return sum(jnp.sum(o * c) for o, c in zip(j_fn(xj), cotangents))

    j_out = j_fn(jnp.asarray(x))
    j_grad = jax.grad(loss)(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    t_out = t_fn(xt)
    sum((o * torch.from_numpy(np.asarray(c))).sum() for o, c in zip(t_out, cotangents)).backward()
    return j_out, j_grad, t_out, xt.grad


def test_average_pool_returns_no_masks():
    x = torch.from_numpy(np.random.RandomState(0).randn(2, 3, 3, C).astype(np.float32))
    pooled, masks = heads.AveragePool()(x)
    ref, ref_masks = jheads.AveragePool().apply({}, jnp.asarray(x.numpy()))
    assert masks is None and ref_masks is None
    _close(pooled.numpy(), ref)
    pooled, _ = heads.AveragePool()(x.bfloat16())
    assert pooled.dtype == torch.bfloat16


def test_attention_pool_forward_and_input_gradient():
    rng = np.random.RandomState(1)
    x = rng.randn(3, 4, 5, C).astype(np.float32)
    jm = jheads.AttentionPool2D()
    params = _perturb(jm.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"], rng)
    tm = _load_head(heads.AttentionPool2D(C), "pool", params).requires_grad_(False)
    cot = [rng.randn(3, C).astype(np.float32), rng.randn(3, 4, 5, 1).astype(np.float32)]
    (j_pool, j_masks), j_grad, (t_pool, t_masks), t_grad = _grad_pair(
        lambda xj: jm.apply({"params": params}, xj), tm, x, cot)
    _close(t_pool.detach().numpy(), j_pool)
    _close(t_masks.detach().numpy(), j_masks)
    np.testing.assert_allclose(t_masks.detach().sum(dim=(1, 2, 3)).numpy(), 1.0, rtol=1e-6)
    _close(t_grad.numpy(), j_grad)


def test_attention_pool_promotes_bf16_to_f32():
    """flax promotes the bf16 features to the f32 conv: pooled and masks are
    f32, from the bf16 values exactly."""
    rng = np.random.RandomState(2)
    x = jnp.asarray(rng.randn(2, 3, 3, C), jnp.bfloat16)
    jm = jheads.AttentionPool2D()
    params = _perturb(jm.init(jax.random.PRNGKey(0), x)["params"], rng)
    j_pool, j_masks = jm.apply({"params": params}, x)
    tm = _load_head(heads.AttentionPool2D(C), "pool", params)
    with torch.no_grad():
        t_pool, t_masks = tm(torch.from_numpy(np.asarray(x, np.float32)).bfloat16())
    assert j_pool.dtype == jnp.float32 and t_pool.dtype == t_masks.dtype == torch.float32
    _close(t_pool.numpy(), j_pool)
    _close(t_masks.numpy(), j_masks)


def test_jigsaw_heads_forward_and_input_gradient():
    rng = np.random.RandomState(3)
    feats = rng.randn(4, 9, C).astype(np.float32)
    perm = np.stack([rng.permutation(9) for _ in range(4)]).astype(np.int32)
    jm = jheads.JigsawHeads(EMBED)
    params = _perturb(jm.init(jax.random.PRNGKey(0), jnp.asarray(feats),
                              jnp.asarray(perm))["params"], rng)
    tm = _load_head(heads.JigsawHeads(C, EMBED), "jigsaw", params).requires_grad_(False)
    cot = [rng.randn(4, EMBED).astype(np.float32)]
    (j_out,), j_grad, (t_out,), t_grad = _grad_pair(
        lambda f: (jm.apply({"params": params}, f, jnp.asarray(perm)),),
        lambda f: (tm(f, torch.from_numpy(perm).long()),), feats, cot)
    _close(t_out.detach().numpy(), j_out)
    _close(t_grad.numpy(), j_grad)
    # the order matters: another permutation gives another output
    assert not np.allclose(tm(torch.from_numpy(feats), torch.from_numpy(perm[::-1].copy()))
                           .detach().numpy(), np.asarray(j_out), atol=1e-3)


@pytest.mark.parametrize("hidden", [(), (C,)])
def test_multi_layer_linear_forward_and_input_gradient(hidden):
    rng = np.random.RandomState(4)
    x = rng.randn(5, C).astype(np.float32)
    jm = jheads.MultiLayerLinear(CLASSES, hidden)
    params = _perturb(jm.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"], rng)
    tm = _load_head(heads.MultiLayerLinear(C, CLASSES, hidden), "imagenet_decoder_1",
                    params).requires_grad_(False)
    cot = [rng.randn(5, CLASSES).astype(np.float32)]
    (j_out,), j_grad, (t_out,), t_grad = _grad_pair(
        lambda xj: (jm.apply({"params": params}, xj),), lambda xt: (tm(xt),), x, cot)
    _close(t_out.detach().numpy(), j_out)
    _close(t_grad.numpy(), j_grad)
    assert tm(torch.from_numpy(x).bfloat16()).dtype == torch.float32


@pytest.mark.parametrize("size", [33, 34, 35])
def test_jigsaw_patchify_matches_jax(size):
    """Sizes divisible by 3 and not (zero padding at the bottom and right)."""
    x = np.random.RandomState(size).randn(2, size, size + 1, 3).astype(np.float32)
    ref = np.asarray(jax_jigsaw_patchify(jnp.asarray(x)))
    got = jigsaw_patchify(torch.from_numpy(x)).numpy()
    assert got.shape == ref.shape == (18, -(-size // 3), -(-(size + 1) // 3), 3)
    np.testing.assert_array_equal(got, ref)


def test_random_jigsaw_perms_are_permutations():
    perms = random_jigsaw_perms(torch.Generator().manual_seed(0), 64)
    assert perms.shape == (64, 9) and perms.dtype == torch.int64
    assert (perms.sort(dim=1).values == torch.arange(9)).all()
    assert len({tuple(p.tolist()) for p in perms}) > 60


def _encoder_options():
    return dict(embed_size=EMBED, use_attention=True, jigsaw=True,
                use_imagenet_decoders=True, num_imagenet_classes=CLASSES, bn_fold="expand")


@pytest.fixture(scope="module")
def encoder():
    """A ResNet18 VinceEncoder with every head, JAX's ``full_init`` tree
    (perturbed) loaded into the port's; both run a train-mode forward, a
    jigsaw forward on the patches and the decoders."""
    rng = np.random.RandomState(5)
    x = rng.randn(2, 33, 33, 3).astype(np.float32)
    perm = np.stack([rng.permutation(9) for _ in range(2)]).astype(np.int32)
    jm = JaxVinceEncoder(backbone_name="ResNet18", stem_kind="s2d", **_encoder_options())
    variables = jax.device_get(jax.jit(functools.partial(jm.init, method=JaxVinceEncoder.full_init))(
        {"params": jax.random.PRNGKey(0)}, jnp.asarray(x)))
    params = _perturb(variables["params"], rng, 0.02)
    stats = variables["batch_stats"]

    @jax.jit
    def run(p, images, patches, perm):
        v = {"params": p, "batch_stats": stats}
        out, _ = jm.apply(v, images, mutable=["batch_stats"])
        jig, _ = jm.apply(v, patches, jigsaw=True, jigsaw_perm=perm, mutable=["batch_stats"])
        logits = jm.apply(v, out["extracted_features"], method=JaxVinceEncoder.imagenet_logits)
        return out, jig, logits

    patches = np.asarray(jax_jigsaw_patchify(jnp.asarray(x)))
    j_out, j_jig, j_logits = jax.device_get(run(params, x, patches, perm))
    tm = VinceEncoder("ResNet18", stem_kind="s2d", **_encoder_options())
    load_jax_variables(tm, params, stats)
    tm.requires_grad_(False)
    t_out = tm(torch.from_numpy(x))
    t_jig = tm(jigsaw_patchify(torch.from_numpy(x)), jigsaw=True,
               jigsaw_perm=torch.from_numpy(perm).long())
    t_logits = tm.imagenet_logits(t_out["extracted_features"])
    return dict(params=params, stats=stats, model=tm, out=(t_out, j_out), jig=(t_jig, j_jig),
                logits=(t_logits, j_logits))


def test_encoder_forward_with_attention(encoder):
    got, ref = encoder["out"]
    assert set(got) == {"extracted_features", "attention_masks", "prenorm_features",
                        "embeddings"} <= set(ref)
    for k in got:
        _close(got[k].detach().numpy(), ref[k], atol=1e-5)
    assert got["attention_masks"].shape == (2, 2, 2, 1)


def test_encoder_jigsaw_forward(encoder):
    """A jigsaw call's extracted features are the jigsaw head's output."""
    got, ref = encoder["jig"]
    assert got["extracted_features"].shape == (2, EMBED)
    for k in ("extracted_features", "prenorm_features", "embeddings"):
        _close(got[k].detach().numpy(), ref[k], atol=1e-5)


def test_encoder_imagenet_logits(encoder):
    got, ref = encoder["logits"]
    for g, r in zip(got, ref):
        assert g.shape == (2, CLASSES)
        _close(g.detach().numpy(), r, atol=1e-5)


def test_split_vince_params_matches_jax(encoder):
    """The tracked set is the backbone, the pool, the projection and the
    jigsaw head; the decoders are the rest."""
    tracked_j, rest_j = jax_split_vince_params(encoder["params"])
    tracked, rest = split_vince_params(dict(encoder["model"].named_parameters()))
    assert set(tracked) == set(flax_to_state_dict(tracked_j, {}))
    assert set(rest) == set(flax_to_state_dict({"backbone": {}, **rest_j}, {}))
    assert {k.split(".")[0] for k in tracked} == {"backbone", "pool", "embedding", "jigsaw"}
    assert {k.split(".")[0] for k in rest} == {"imagenet_decoder_0", "imagenet_decoder_1"}


def test_head_names_match_the_jax_exporter(encoder):
    """Every tensor of the encoder with all heads equals the JAX package's
    reference-format export under the mapped name, and the mapping covers
    the whole export."""
    exported = export_vince_state_dict(encoder["params"], encoder["stats"])
    model = VinceEncoder("ResNet18", **_encoder_options())
    load_jax_variables(model, encoder["params"], encoder["stats"])
    loaded = model.state_dict()
    assert {to_reference_name(k) for k in loaded} == {
        k for k in exported if not k.endswith("num_batches_tracked")}
    for k, v in loaded.items():
        np.testing.assert_array_equal(v.numpy(), exported[to_reference_name(k)], err_msg=k)
