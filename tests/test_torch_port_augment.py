"""The port's augmentation against ``vince_tpu.ops.augment`` with the same
injected draws: the bilinear and gaussian operators, ``color_jitter_apply``,
``_finalize`` and the whole train-mode pipeline, the jitter in the fixed
order too, the val path, and the named pipelines' configs."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vince_tpu.ops import augment as ja
from vince_tpu.utils import transforms as jax_transforms
from vince_tpu.utils.transforms import make_config as jax_make_config
from vince_tpu_torch.ops import augment as ta
from vince_tpu_torch.utils.transforms import make_config
from torch_port_threads import one_intra_op_thread  # noqa: F401  (a module fixture)

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


def _jax_pipeline(d, images, cfg_j):
    """The JAX pipeline's steps in ``augment_batch`` order with the draws ``d``."""
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
    return ja._finalize(out, cfg_j)


@pytest.mark.parametrize("transform", ["StandardVideoTransform", "SimCLRTransform"])
def test_pipeline_matches_jax_composition(transform):
    """``apply_augment`` equals the JAX pipeline's steps in ``augment_batch``
    order, given the same draws."""
    d = _draws()
    images = _images()
    ref = _jax_pipeline(d, images, jax_make_config(transform, OUT))
    cfg_t = make_config(transform, OUT)
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


# the val path: downsampling (the antialiased kernel widens), upsampling, and
# the published shape, where the resize is the identity and only the crop acts
VAL_CASES = [(80, 32), (24, 32), (256, 224)]


@pytest.mark.parametrize("canvas,size", VAL_CASES)
def test_val_resize_center_crop_matches_jax(canvas, size):
    img = (_images(seed=8, b=2, size=canvas) / 255.0).astype(np.float32)
    ref = ja.val_resize_center_crop(jnp.asarray(img), (size, size))
    got = ta.val_resize_center_crop(_t(img), (size, size))
    assert got.shape == ref.shape == (2, size, size, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=1e-5)
    if canvas == 256:  # 256 = 224 / 0.875: a crop, exactly
        np.testing.assert_array_equal(got.numpy(), img[:, 16:240, 16:240])


@pytest.mark.parametrize("canvas,size", VAL_CASES)
def test_val_augment_batch_matches_jax(canvas, size):
    """``augment_batch(train=False)`` on uint8 canvases: the crop, then
    ``_finalize``; it draws nothing."""
    images = _images(seed=9, b=2, size=canvas)
    ref = ja.augment_batch(None, jnp.asarray(images), jax_make_config("StandardVideoTransform", size),
                           train=False)
    got = ta.augment_batch(None, _t(images), make_config("StandardVideoTransform", size),
                           train=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=1e-5)


def _fixed_jitter_jax(img, d, cfg_j):
    """JAX's ``_color_jitter_batch`` in the fixed order, its draws replaced,
    in the order it makes them, by the test's: the apply coin, then the
    brightness, contrast, saturation and hue draws before its own masking."""
    values = iter([np.where(d["jitter"], 0.0, 1.0).astype(np.float32),
                   d["fb"], d["fc"], d["fs"], d["fh"]])
    return ja._color_jitter_batch(jax.random.PRNGKey(0), jnp.asarray(img), cfg_j,
                                  draw=lambda key, **kw: jnp.asarray(next(values)))


def _fixed_draws(d):
    """The port's draws of the same values: factors 1 and shift 0 where the
    coin said no jitter."""
    on = d["jitter"]
    return {**d, **{k: np.where(on, d[k], 1.0).astype(np.float32) for k in ("fb", "fc", "fs")},
            "fh": np.where(on, d["fh"], 0.0).astype(np.float32)}


@pytest.mark.parametrize("hue", [0.2, 0.0])
def test_fixed_order_jitter_matches_jax(hue):
    """``jitter_order="fixed"``: brightness, contrast, saturation, then the
    YIQ hue rotation, against JAX's own function with the same draws."""
    d = _draws(seed=3)
    img = (_images(seed=4) / 255.0).astype(np.float32)
    cfg_j = ja.AugmentConfig(hue=hue, jitter_order="fixed")
    cfg_t = ta.AugmentConfig(hue=hue, jitter_order="fixed")
    ref = _fixed_jitter_jax(img, d, cfg_j)
    f = _fixed_draws(d)
    got = ta.color_jitter_fixed(_t(img), *(_t(f[k]) for k in ("fb", "fc", "fs", "fh")), cfg_t)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=2e-6)


def test_fixed_order_pipeline_matches_jax_composition():
    """``apply_augment`` in the fixed order (JigsawTransform: strong jitter,
    grayscale, blur) equals the JAX pipeline's steps in ``augment_batch``
    order with the same draws; no identity where jitter is off (JAX keeps the
    rotation's rounding there too)."""
    d = _draws(seed=5)
    images = _images(seed=6)
    cfg_j = jax_make_config("JigsawTransform", OUT, jitter_order="fixed")
    cfg_t = make_config("JigsawTransform", OUT, jitter_order="fixed")
    imgs = jnp.asarray(images).astype(jnp.float32) / 255.0
    w_y = ja._bilinear_matrix(jnp.asarray(d["crop_i"]), jnp.asarray(d["crop_h"]), IN, OUT)
    w_x = ja._bilinear_matrix(jnp.asarray(d["crop_j"]), jnp.asarray(d["crop_w"]), IN, OUT,
                              flip=jnp.asarray(d["flip"]))
    out = jnp.clip(ja._apply_separable(imgs, w_y, w_x), 0.0, 1.0)
    out = _fixed_jitter_jax(out, d, cfg_j)
    gray = jnp.broadcast_to(ja._rgb_to_grayscale(out), out.shape)
    out = jnp.where(jnp.asarray(d["gray"])[:, None, None, None], gray, out)
    g = ja._gaussian_matrix(jnp.asarray(d["sigma"]), jnp.asarray(d["blur"]), OUT,
                            cfg_j.blur_kernel)
    ref = ja._finalize(ja._apply_separable(out, g, g), cfg_j)

    draws = ta.AugmentDraws(**{k: _t(v) for k, v in _fixed_draws(d).items()})
    draws.perm = draws.perm.long()
    got = ta.apply_augment(_t(images), draws, cfg_t)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=2e-5)


def test_fixed_order_draws_keep_the_unclipped_factor_range():
    """The fixed order draws factors in [1 − s, 1 + s] as JAX's does; the
    torchvision order clips the range at 0."""
    cfg = ta.AugmentConfig(brightness=1.5, color_jitter_prob=1.0)
    for order, low in (("fixed", -0.5), ("torchvision", 0.0)):
        d = ta.draw_augment_params(torch.Generator().manual_seed(0), 4096, 40, 40,
                                   ta.AugmentConfig(**{**cfg.__dict__, "jitter_order": order}))
        assert low <= d.fb.min() < low + 0.05 and 2.45 < d.fb.max() <= 2.5, order
    with pytest.raises(ValueError, match="jitter_order"):
        ta.draw_augment_params(torch.Generator(), 2, 40, 40, ta.AugmentConfig(jitter_order="yiq"))


@pytest.mark.parametrize("name", jax_transforms.__all__)
@pytest.mark.parametrize("jitter_order", [None, "fixed"])
def test_named_pipelines_match_jax(name, jitter_order):
    """Each of the JAX package's named pipelines has the port's config field
    for field."""
    ref = jax_make_config(name, (48, 40), jitter_order=jitter_order)
    got = make_config(name, (48, 40), jitter_order=jitter_order)
    assert dataclasses.asdict(got) == dataclasses.asdict(ref)


@pytest.mark.parametrize("group_size", [2, 3])
def test_group_draws_are_shared_by_a_clips_frames(group_size):
    """``group_size=T``: one draw per clip of T consecutive rows, repeated
    over its frames (crop box, flip, jitter, order, grayscale, blur), and
    clips draw apart."""
    cfg = make_config("SimCLRTransform", OUT)
    d = ta.draw_augment_params(torch.Generator().manual_seed(0), 4 * group_size, IN, IN, cfg,
                               group_size=group_size)
    for f in dataclasses.fields(d):
        v = getattr(d, f.name).reshape(4, group_size, *getattr(d, f.name).shape[1:])
        assert (v == v[:, :1]).all(), f.name
    assert len(set(d.crop_i.tolist() + d.crop_w.tolist())) > 2
    with pytest.raises(ValueError, match="groups of"):
        ta.draw_augment_params(torch.Generator(), 5, IN, IN, cfg, group_size=group_size)


@pytest.mark.parametrize("group_size", [2, 3])
def test_grouped_augment_batch_gives_a_clip_one_augmentation_as_jax_does(group_size):
    """A clip of T copies of one frame comes out of ``augment_batch`` as T
    equal frames, in both packages; the clips differ."""
    clips = _images(seed=4, b=3)
    frames = np.repeat(clips, group_size, axis=0)
    for out in (ta.augment_batch(torch.Generator().manual_seed(1), _t(frames),
                                 make_config("SimCLRTransform", OUT), group_size=group_size).numpy(),
                np.asarray(ja.augment_batch(jax.random.PRNGKey(1), jnp.asarray(frames),
                                            jax_make_config("SimCLRTransform", OUT),
                                            group_size=group_size))):
        out = out.reshape(3, group_size, OUT, OUT, 3)
        np.testing.assert_array_equal(out, np.repeat(out[:, :1], group_size, axis=1))
        assert not np.allclose(out[0, 0], out[1, 0])


@pytest.mark.parametrize("transform", ["StandardVideoTransform", "SimCLRTransform"])
def test_grouped_draws_applied_match_jax_composition(transform):
    """The port's draws of 2 clips x 3 frames, applied by ``apply_augment``,
    equal the JAX pipeline's steps with the same (repeated) draws."""
    cfg_t = make_config(transform, OUT)
    draws = ta.draw_augment_params(torch.Generator().manual_seed(2), B, IN, IN, cfg_t,
                                   group_size=3)
    d = {f.name: getattr(draws, f.name).numpy() for f in dataclasses.fields(draws)}
    images = _images(seed=5)
    ref = _jax_pipeline(d, images, jax_make_config(transform, OUT))
    got = ta.apply_augment(_t(images), draws, cfg_t)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=2e-5)
