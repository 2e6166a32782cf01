"""The port's augmentation against ``vince_tpu.ops.augment`` with the same
injected draws: the bilinear and gaussian operators, ``color_jitter_apply``,
``_finalize`` and the whole train-mode pipeline."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vince_tpu.ops import augment as ja
from vince_tpu.utils.transforms import make_config as jax_make_config
from vince_tpu_torch.ops import augment as ta
from vince_tpu_torch.utils.transforms import make_config

B, IN, OUT = 6, 40, 32


def _draws(seed=0, b=B):
    rng = np.random.RandomState(seed)
    h = rng.randint(12, IN + 1, b).astype(np.float32)
    w = rng.randint(12, IN + 1, b).astype(np.float32)
    return dict(
        crop_i=np.floor(rng.rand(b) * (IN - h + 1)).astype(np.float32), crop_h=h,
        crop_j=np.floor(rng.rand(b) * (IN - w + 1)).astype(np.float32), crop_w=w,
        flip=rng.rand(b) < 0.5, jitter=rng.rand(b) < 0.8,
        fb=rng.uniform(0.6, 1.4, b).astype(np.float32),
        fc=rng.uniform(0.6, 1.4, b).astype(np.float32),
        fs=rng.uniform(0.6, 1.4, b).astype(np.float32),
        fh=rng.uniform(-0.2, 0.2, b).astype(np.float32),
        perm=np.argsort(rng.rand(b, 4), axis=1).astype(np.int32),
        gray=rng.rand(b) < 0.3, blur=rng.rand(b) < 0.5,
        sigma=rng.uniform(0.1, 2.0, b).astype(np.float32))


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _images(seed=1, b=B, size=IN):
    return np.random.RandomState(seed).randint(0, 256, (b, size, size, 3), np.uint8)


@pytest.mark.parametrize("flip", [False, True])
def test_bilinear_matrix_matches_jax(flip):
    d = _draws()
    f = d["flip"] if flip else None
    ref = ja._bilinear_matrix(jnp.asarray(d["crop_i"]), jnp.asarray(d["crop_h"]), IN, OUT,
                              flip=None if f is None else jnp.asarray(f))
    got = ta._bilinear_matrix(_t(d["crop_i"]), _t(d["crop_h"]), IN, OUT,
                              flip=None if f is None else _t(f))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-7)


def test_gaussian_matrix_and_separable_apply_match_jax():
    d = _draws()
    img = (_images() / 255.0).astype(np.float32)
    g_ref = ja._gaussian_matrix(jnp.asarray(d["sigma"]), jnp.asarray(d["blur"]), IN, 5)
    g = ta._gaussian_matrix(_t(d["sigma"]), _t(d["blur"]), IN, 5)
    np.testing.assert_allclose(g.numpy(), np.asarray(g_ref), rtol=1e-6, atol=1e-7)
    ref = ja._apply_separable(jnp.asarray(img), g_ref, g_ref)
    got = ta._apply_separable(_t(img), g, g)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("hue", [0.2, 0.0])
def test_color_jitter_apply_matches_jax(hue):
    d = _draws()
    img = (_images() / 255.0).astype(np.float32)
    cfg_j = ja.AugmentConfig(hue=hue)
    cfg_t = ta.AugmentConfig(hue=hue)
    args = [d[k] for k in ("perm", "fb", "fc", "fs", "fh")]
    ref = ja.color_jitter_apply(jnp.asarray(img), *map(jnp.asarray, args), cfg_j)
    got = ta.color_jitter_apply(_t(img), _t(d["perm"]).long(), *map(_t, args[1:]), cfg_t)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


def test_finalize_matches_jax():
    img = (_images() / 255.0).astype(np.float32)
    ref = ja._finalize(jnp.asarray(img), ja.AugmentConfig())
    np.testing.assert_allclose(ta._finalize(_t(img), ta.AugmentConfig()).numpy(),
                               np.asarray(ref), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("transform", ["StandardVideoTransform", "SimCLRTransform"])
def test_pipeline_matches_jax_composition(transform):
    """``apply_augment`` equals the JAX pipeline's steps in ``augment_batch``
    order, given the same draws."""
    d = _draws()
    images = _images()
    cfg_j = jax_make_config(transform, OUT)
    cfg_t = make_config(transform, OUT)
    imgs = jnp.asarray(images).astype(jnp.float32) / 255.0
    w_y = ja._bilinear_matrix(jnp.asarray(d["crop_i"]), jnp.asarray(d["crop_h"]), IN, OUT)
    w_x = ja._bilinear_matrix(jnp.asarray(d["crop_j"]), jnp.asarray(d["crop_w"]), IN, OUT,
                              flip=jnp.asarray(d["flip"]))
    out = jnp.clip(ja._apply_separable(imgs, w_y, w_x), 0.0, 1.0)
    jit = ja.color_jitter_apply(out, *(jnp.asarray(d[k]) for k in ("perm", "fb", "fc", "fs", "fh")),
                                cfg_j)
    out = jnp.where(jnp.asarray(d["jitter"])[:, None, None, None], jit, out)
    gray = jnp.broadcast_to(ja._rgb_to_grayscale(out), out.shape)
    out = jnp.where(jnp.asarray(d["gray"])[:, None, None, None], gray, out)
    if cfg_j.blur_prob > 0:
        g = ja._gaussian_matrix(jnp.asarray(d["sigma"]), jnp.asarray(d["blur"]), OUT,
                                cfg_j.blur_kernel)
        out = ja._apply_separable(out, g, g)
    ref = ja._finalize(out, cfg_j)

    draws = ta.AugmentDraws(**{k: _t(v) for k, v in d.items()})
    draws.perm = draws.perm.long()
    got = ta.apply_augment(_t(images), draws, cfg_t)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=2e-5)


def test_draws_are_valid_crops_and_permutations():
    cfg = make_config("StandardVideoTransform", 224)
    d = ta.draw_augment_params(torch.Generator().manual_seed(0), 64, 256, 300, cfg)
    assert (d.crop_i >= 0).all() and (d.crop_i + d.crop_h <= 256).all()
    assert (d.crop_j >= 0).all() and (d.crop_j + d.crop_w <= 300).all()
    area = d.crop_h * d.crop_w / (256 * 300)
    assert (area > 0.19).all() and (area <= 1.0).all()
    assert (d.perm.sort(dim=1).values == torch.arange(4)).all()
    out = ta.augment_batch(torch.Generator().manual_seed(0),
                           torch.from_numpy(_images(size=64)), make_config(
                               "StandardVideoTransform", 32), dtype=torch.bfloat16)
    assert out.shape == (B, 32, 32, 3) and out.dtype == torch.bfloat16
    assert torch.isfinite(out.float()).all()
