"""Batched image augmentation on the device (counterpart of
``vince_tpu/ops/augment.py``): the train path and the val path.

The random numbers are drawn in one function (``draw_augment_params``, from
a ``torch.Generator``) and applied by a deterministic one
(``apply_augment``), so a test can feed the JAX and the PyTorch pipelines the
same draws. The geometric ops (random resized crop, horizontal flip, gaussian
blur) are per-sample separable linear operators applied as two batched
matmuls, ``out = W_y · img · W_xᵀ``: the JAX package records a gather
formulation as a 500× regression. Colour jitter follows torchvision's
float-tensor semantics with a per-sample random op order and one HSV pass
(``jitter_order="torchvision"``), or in the fixed order brightness →
contrast → saturation → hue with the hue as a rotation in the YIQ plane
(``"fixed"``). The val path resizes by ``jax.image.resize``'s linear kernel
and crops the centre, also as two matmuls.

The body of both paths reads no host data, so a CUDA graph can capture it:
its constant vectors are made once per device and type (``_constant``).
"""

import dataclasses
import functools
import math
from typing import Tuple

import torch

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
_GRAY_WEIGHTS = (0.299, 0.587, 0.114)  # ITU-R 601-2 luma, as PIL convert("L")
# RGB ↔ YIQ, the fixed order's hue rotation (the luma row is _GRAY_WEIGHTS)
_RGB2YIQ = ((0.299, 0.587, 0.114), (0.596, -0.274, -0.322), (0.211, -0.523, 0.312))
_YIQ2RGB = ((1.0, 0.956, 0.621), (1.0, -0.272, -0.647), (1.0, -1.106, 1.703))


@dataclasses.dataclass(frozen=True)
class AugmentConfig:
    size: Tuple[int, int] = (224, 224)
    crop_scale: Tuple[float, float] = (0.2, 1.0)
    crop_ratio: Tuple[float, float] = (3.0 / 4.0, 4.0 / 3.0)
    brightness: float = 0.4
    contrast: float = 0.4
    saturation: float = 0.4
    hue: float = 0.2
    color_jitter_prob: float = 1.0
    grayscale_prob: float = 0.2
    hflip_prob: float = 0.5
    blur_prob: float = 0.0
    blur_sigma: Tuple[float, float] = (0.1, 2.0)
    normalize: bool = True
    jitter_order: str = "torchvision"

    @property
    def blur_kernel(self) -> int:
        k = max(self.size[0] // 10, 3)
        return k + 1 - (k % 2)  # odd


@dataclasses.dataclass
class AugmentDraws:
    """Every random number one train-mode ``augment_batch`` call uses, [B] each
    (``perm`` [B, 4])."""

    crop_i: torch.Tensor
    crop_j: torch.Tensor
    crop_h: torch.Tensor
    crop_w: torch.Tensor
    flip: torch.Tensor  # bool
    jitter: torch.Tensor  # bool — colour jitter applied
    # brightness / contrast / saturation blend factors, 1 where jitter is off
    fb: torch.Tensor
    fc: torch.Tensor
    fs: torch.Tensor
    fh: torch.Tensor  # hue shift in turns, 0 where jitter is off
    perm: torch.Tensor  # int64 per-sample op order of (b, c, s, hue); unread in "fixed"
    gray: torch.Tensor  # bool
    blur: torch.Tensor  # bool
    sigma: torch.Tensor


# ---------------------------------------------------------------------------
# colour helpers


@functools.lru_cache(maxsize=None)
def _constant(values: Tuple[float, ...], dtype: torch.dtype, device: torch.device):
    """``values`` as a tensor on ``device``, made on the first call (a copy
    from the host, which a stream capture does not allow) and kept."""
    return torch.tensor(values, dtype=dtype, device=device)


def _rgb_to_grayscale(img):
    w = _constant(_GRAY_WEIGHTS, img.dtype, img.device)
    return (img * w).sum(dim=-1, keepdim=True)


def _rgb_to_hsv(img):
    r, g, b = img[..., 0], img[..., 1], img[..., 2]
    maxc = torch.maximum(torch.maximum(r, g), b)
    minc = torch.minimum(torch.minimum(r, g), b)
    delta = maxc - minc
    s = torch.where(maxc > 0, delta / maxc.clamp(min=1e-12), 0.0)
    dc = delta.clamp(min=1e-12)
    rc, gc, bc = (maxc - r) / dc, (maxc - g) / dc, (maxc - b) / dc
    h = torch.where(maxc == r, bc - gc,
                    torch.where(maxc == g, 2.0 + rc - bc, 4.0 + gc - rc))
    h = torch.where(delta > 0, torch.remainder(h / 6.0, 1.0), 0.0)
    return torch.stack([h, s, maxc], dim=-1)


def _hsv_to_rgb(img):
    h, s, v = img[..., 0], img[..., 1], img[..., 2]
    i = torch.floor(h * 6.0)
    f = h * 6.0 - i
    p = v * (1.0 - s)
    q = v * (1.0 - f * s)
    t = v * (1.0 - (1.0 - f) * s)
    i = torch.remainder(i.to(torch.int32), 6)

    def pick(c0, c1, c2, c3, c4, c5):
        return torch.where(i == 0, c0, torch.where(i == 1, c1, torch.where(
            i == 2, c2, torch.where(i == 3, c3, torch.where(i == 4, c4, c5)))))

    return torch.stack([pick(v, q, p, p, t, v), pick(t, v, v, q, p, p),
                        pick(p, p, t, v, v, q)], dim=-1)


def _adjust_hue_hsv(img, shift):
    """h ← (h + shift) mod 1 per sample; img [B,H,W,3] in [0,1], shift [B]."""
    hsv = _rgb_to_hsv(img)
    h = torch.remainder(hsv[..., 0] + shift[:, None, None], 1.0)
    return _hsv_to_rgb(torch.stack([h, hsv[..., 1], hsv[..., 2]], dim=-1))


# ---------------------------------------------------------------------------
# random resized crop (torchvision get_params), batched over samples and tries


def sample_crop_boxes(generator, batch: int, in_h: int, in_w: int, cfg: AugmentConfig):
    """10-attempt rejection sampling; returns (i, j, h, w) float32 [B]."""
    dev = generator.device

    def uniform(lo, hi):
        return torch.rand(batch, 10, generator=generator, device=dev) * (hi - lo) + lo

    area = float(in_h * in_w)
    target_area = area * uniform(*cfg.crop_scale)
    aspect = torch.exp(uniform(math.log(cfg.crop_ratio[0]), math.log(cfg.crop_ratio[1])))
    w = torch.round(torch.sqrt(target_area * aspect))
    h = torch.round(torch.sqrt(target_area / aspect))
    valid = (w > 0) & (w <= in_w) & (h > 0) & (h <= in_h)
    first = valid.float().argmax(dim=1, keepdim=True)  # first valid attempt
    any_valid = valid.any(dim=1)

    def take(x):
        return x.gather(1, first)[:, 0]

    sel_h, sel_w = take(h), take(w)
    u_i, u_j = take(uniform(0.0, 1.0)), take(uniform(0.0, 1.0))
    i = torch.floor(u_i * (in_h - sel_h + 1))
    j = torch.floor(u_j * (in_w - sel_w + 1))
    # centre fallback clamped to the ratio range
    in_ratio = in_w / in_h
    if in_ratio < cfg.crop_ratio[0]:
        fb_w, fb_h = float(in_w), float(round(in_w / cfg.crop_ratio[0]))
    elif in_ratio > cfg.crop_ratio[1]:
        fb_w, fb_h = float(round(in_h * cfg.crop_ratio[1])), float(in_h)
    else:
        fb_w, fb_h = float(in_w), float(in_h)
    fb_i, fb_j = (in_h - fb_h) // 2, (in_w - fb_w) // 2
    return (torch.where(any_valid, i, fb_i), torch.where(any_valid, j, fb_j),
            torch.where(any_valid, sel_h, fb_h), torch.where(any_valid, sel_w, fb_w))


# ---------------------------------------------------------------------------
# separable linear operators


def _bilinear_matrix(start, size, in_dim: int, out_dim: int, flip=None):
    """Per-sample bilinear sampling operators W [B, out_dim, in_dim]:
    (W · v)[i] = v at start + (i + .5)·size/out − .5, edge-clamped; ``flip``
    [B] bool reverses the output order."""
    dev = start.device
    idx_out = torch.arange(out_dim, dtype=torch.float32, device=dev)[None, :]
    if flip is not None:
        idx_out = torch.where(flip[:, None], out_dim - 1.0 - idx_out, idx_out)
    else:
        idx_out = idx_out.expand(start.shape[0], out_dim)
    src = start[:, None] + (idx_out + 0.5) * (size[:, None] / out_dim) - 0.5
    src = src.clamp(0.0, in_dim - 1.0)
    j = torch.arange(in_dim, dtype=torch.float32, device=dev)
    w = torch.clamp(1.0 - torch.abs(src[:, :, None] - j[None, None, :]), min=0.0)
    return w / w.sum(dim=-1, keepdim=True).clamp(min=1e-8)


def _gaussian_matrix(sigma, apply_mask, dim: int, kernel: int):
    """Per-sample truncated-gaussian Toeplitz operators G [B, dim, dim];
    identity where ``apply_mask`` is False."""
    half = (kernel - 1) // 2
    idx = torch.arange(dim, dtype=torch.float32, device=sigma.device)
    d = idx[:, None] - idx[None, :]
    g = torch.exp(-0.5 * (d[None] / sigma[:, None, None]) ** 2)
    g = torch.where(torch.abs(d)[None] <= half, g, 0.0)
    g = g / g.sum(dim=-1, keepdim=True).clamp(min=1e-8)
    eye = torch.eye(dim, device=sigma.device)[None]
    return torch.where(apply_mask[:, None, None], g, eye)


def _resize_matrix(in_dim: int, out_dim: int, device) -> torch.Tensor:
    """[out_dim, in_dim] operator of ``jax.image.resize(method="linear")``
    along one axis (``jax.image.scale_and_translate``'s weights): the triangle
    kernel, widened by the scale when it downsamples (antialiasing), each
    output's weights normalised to sum to one, zero for a sample outside the
    input; the identity where the sizes are equal, which JAX skips."""
    if in_dim == out_dim:
        return torch.eye(in_dim, device=device)
    inv_scale = in_dim / out_dim
    kernel_scale = max(inv_scale, 1.0)
    sample = (torch.arange(out_dim, dtype=torch.float32, device=device) + 0.5) * inv_scale - 0.5
    src = torch.arange(in_dim, dtype=torch.float32, device=device)
    w = torch.clamp(1.0 - torch.abs(sample[:, None] - src[None, :]) / kernel_scale, min=0.0)
    total = w.sum(dim=-1, keepdim=True)
    w = torch.where(torch.abs(total) > 1000.0 * torch.finfo(torch.float32).eps,
                    w / torch.where(total != 0, total, 1.0), 0.0)
    inside = (sample >= -0.5) & (sample <= in_dim - 0.5)
    return torch.where(inside[:, None], w, 0.0)


def _apply_separable(img, w_y, w_x):
    """img [B,H,W,C] · per-sample operators → [B,out_h,out_w,C], two batched matmuls."""
    out = torch.einsum("bij,bjwc->biwc", w_y, img)
    return torch.einsum("bkw,bhwc->bhkc", w_x, out)


# ---------------------------------------------------------------------------
# colour jitter


def color_jitter_apply(img, perm, fb, fc, fs, fh, cfg: AugmentConfig):
    """The four jitter ops in per-sample order ``perm`` [B,4] (0 brightness,
    1 contrast, 2 saturation, 3 hue); fb/fc/fs blend factors (1 = identity),
    fh hue shift in turns. The HSV round trip runs once: every order holds
    hue exactly once, so the blends before it and after it are two groups of
    at most three stages."""
    any_blend = cfg.brightness or cfg.contrast or cfg.saturation

    def blend_stages(img, active, stages):
        # each stage applies at most one blend op per sample, and each is the
        # channel-affine map clip(a·img + bg·gray(img) + cm·mean(gray(img)))
        if not any_blend:
            return img
        for t in stages:
            op = perm[:, t]
            on = active(t)
            a = torch.ones_like(fb)
            bg = torch.zeros_like(fb)
            cm = torch.zeros_like(fb)
            if cfg.brightness:
                a = torch.where((op == 0) & on, fb, a)
            if cfg.contrast:
                sel = (op == 1) & on
                a = torch.where(sel, fc, a)
                cm = torch.where(sel, 1.0 - fc, cm)
            if cfg.saturation:
                sel = (op == 2) & on
                a = torch.where(sel, fs, a)
                bg = torch.where(sel, 1.0 - fs, bg)
            out = a[:, None, None, None] * img
            if cfg.contrast or cfg.saturation:
                gray = _rgb_to_grayscale(img)
            if cfg.saturation:
                out = out + bg[:, None, None, None] * gray
            if cfg.contrast:
                out = out + cm[:, None, None, None] * gray.mean(dim=(1, 2, 3), keepdim=True)
            img = out.clamp(0.0, 1.0)
        return img

    if not cfg.hue:
        return blend_stages(img, lambda t: True, range(4))
    h_pos = (perm == 3).float().argmax(dim=1)  # hue's stage per sample
    img = blend_stages(img, lambda t: t < h_pos, range(3))
    img = _adjust_hue_hsv(img, fh)
    return blend_stages(img, lambda t: t > h_pos, range(1, 4))


def _hue_rotate(img, shift):
    """Rotate the chroma (I, Q) of each sample by ``shift`` [B] turns; the
    luma is kept."""
    theta = (2.0 * math.pi) * shift
    cos, sin = torch.cos(theta)[:, None, None], torch.sin(theta)[:, None, None]
    yiq = img @ _constant(_RGB2YIQ, img.dtype, img.device).T
    y, i, q = yiq.unbind(dim=-1)
    rotated = torch.stack([y, i * cos - q * sin, i * sin + q * cos], dim=-1)
    return (rotated @ _constant(_YIQ2RGB, img.dtype, img.device).T).clamp(0.0, 1.0)


def color_jitter_fixed(img, fb, fc, fs, fh, cfg: AugmentConfig):
    """The jitter in the fixed order brightness → contrast → saturation → hue
    (``jitter_order="fixed"``), each op a blend clip(f·img + (1−f)·other) and
    the hue a YIQ rotation; a factor of 1 and a shift of 0 where jitter is off."""

    def blend(img, other, factor):
        f = factor[:, None, None, None]
        return (img * f + other * (1.0 - f)).clamp(0.0, 1.0)

    if cfg.brightness:
        img = blend(img, torch.zeros_like(img), fb)
    if cfg.contrast:
        img = blend(img, _rgb_to_grayscale(img).mean(dim=(1, 2, 3), keepdim=True), fc)
    if cfg.saturation:
        img = blend(img, _rgb_to_grayscale(img), fs)
    if cfg.hue:
        img = _hue_rotate(img, fh)
    return img


def _finalize(out, cfg: AugmentConfig):
    if cfg.normalize:
        mean = _constant(IMAGENET_MEAN, out.dtype, out.device)
        std = _constant(IMAGENET_STD, out.dtype, out.device)
        out = (out - mean) / std
    return out


# ---------------------------------------------------------------------------
# the pipeline


def draw_augment_params(generator: torch.Generator, batch: int, in_h: int, in_w: int,
                        cfg: AugmentConfig, group_size: int = 1) -> AugmentDraws:
    """Every random number of one train-mode call, from ``generator`` on its
    device. With ``group_size=T`` one draw is made for each run of T
    consecutive rows and repeated over them: crop box, flip, jitter factors
    and order, grayscale and blur are shared by a clip's frames (Kinetics'
    clip semantics)."""
    if cfg.jitter_order not in ("torchvision", "fixed"):
        raise ValueError(f"jitter_order={cfg.jitter_order!r}; choices: torchvision, fixed")
    if batch % group_size:
        raise ValueError(f"a batch of {batch} rows is no whole number of groups of {group_size}")
    if group_size > 1:
        draws = draw_augment_params(generator, batch // group_size, in_h, in_w, cfg)
        return AugmentDraws(**{f.name: getattr(draws, f.name).repeat_interleave(group_size, dim=0)
                               for f in dataclasses.fields(draws)})
    dev = generator.device

    def uniform(lo=0.0, hi=1.0, shape=(batch,)):
        return torch.rand(*shape, generator=generator, device=dev) * (hi - lo) + lo

    crop = sample_crop_boxes(generator, batch, in_h, in_w, cfg)
    flip = uniform() < cfg.hflip_prob
    jitter = uniform() < cfg.color_jitter_prob

    def factor(strength):
        # torchvision clips the factor's range at 0; the fixed order does not
        lo = 1.0 - strength if cfg.jitter_order == "fixed" else max(0.0, 1.0 - strength)
        return torch.where(jitter, uniform(lo, 1.0 + strength), 1.0)

    ones = torch.ones(batch, device=dev)
    fb = factor(cfg.brightness) if cfg.brightness else ones
    fc = factor(cfg.contrast) if cfg.contrast else ones
    fs = factor(cfg.saturation) if cfg.saturation else ones
    fh = torch.where(jitter, uniform(-cfg.hue, cfg.hue), 0.0) if cfg.hue else 0.0 * ones
    perm = torch.argsort(uniform(shape=(batch, 4)), dim=1)
    gray = uniform() < cfg.grayscale_prob
    blur = uniform() < cfg.blur_prob
    sigma = uniform(*cfg.blur_sigma)
    return AugmentDraws(*crop, flip=flip, jitter=jitter, fb=fb, fc=fc, fs=fs, fh=fh,
                        perm=perm, gray=gray, blur=blur, sigma=sigma)


def draw_rank_rows(generator: torch.Generator, batch: int, in_h: int, in_w: int,
                   cfg: AugmentConfig, group_size: int = 1, data_size: int = 1,
                   data_index: int = 0) -> AugmentDraws:
    """Draws for the ``batch·data_size`` rows of a global batch, of which the
    rank of data index ``data_index`` keeps its ``batch``: a row's draw does
    not depend on the mesh's shape."""
    draws = draw_augment_params(generator, batch * data_size, in_h, in_w, cfg, group_size)
    if data_size == 1:
        return draws
    rows = slice(data_index * batch, (data_index + 1) * batch)
    return AugmentDraws(**{f.name: getattr(draws, f.name)[rows] for f in dataclasses.fields(draws)})


def apply_augment(images: torch.Tensor, draws: AugmentDraws, cfg: AugmentConfig,
                  dtype=torch.float32) -> torch.Tensor:
    """Deterministic train-mode augmentation of [B,H,W,3] uint8 (or unit
    float) images with the given draws → [B, size, size, 3] in ``dtype``."""
    imgs = images.float()
    if images.dtype == torch.uint8:
        imgs = imgs / 255.0
    _, in_h, in_w, _ = imgs.shape
    out_h, out_w = cfg.size
    w_y = _bilinear_matrix(draws.crop_i, draws.crop_h, in_h, out_h)
    w_x = _bilinear_matrix(draws.crop_j, draws.crop_w, in_w, out_w, flip=draws.flip)
    out = _apply_separable(imgs, w_y, w_x).clamp(0.0, 1.0)
    if cfg.brightness or cfg.contrast or cfg.saturation or cfg.hue:
        if cfg.jitter_order == "fixed":
            out = color_jitter_fixed(out, draws.fb, draws.fc, draws.fs, draws.fh, cfg)
        else:
            jittered = color_jitter_apply(out, draws.perm, draws.fb, draws.fc, draws.fs,
                                          draws.fh, cfg)
            # exact identity where jitter is off (the HSV round trip is not)
            out = torch.where(draws.jitter[:, None, None, None], jittered, out)
    if cfg.grayscale_prob > 0:
        out = torch.where(draws.gray[:, None, None, None],
                          _rgb_to_grayscale(out).expand_as(out), out)
    if cfg.blur_prob > 0:
        g_y = _gaussian_matrix(draws.sigma, draws.blur, out_h, cfg.blur_kernel)
        g_x = _gaussian_matrix(draws.sigma, draws.blur, out_w, cfg.blur_kernel)
        out = _apply_separable(out, g_y, g_x)
    return _finalize(out, cfg).to(dtype)


def val_resize_center_crop(images: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """Resize [B,H,W,C] to size/0.875 and crop the centre (JAX
    ``val_resize_center_crop``): the crop keeps rows of the resize operators,
    which are then applied as two batched matmuls."""
    b, in_h, in_w, _ = images.shape
    rh, rw = int(size[0] / 0.875), int(size[1] / 0.875)
    i, j = (rh - size[0]) // 2, (rw - size[1]) // 2
    w_y = _resize_matrix(in_h, rh, images.device)[i:i + size[0]]
    w_x = _resize_matrix(in_w, rw, images.device)[j:j + size[1]]
    return _apply_separable(images, w_y.expand(b, -1, -1), w_x.expand(b, -1, -1))


def augment_batch(generator: torch.Generator, images: torch.Tensor, cfg: AugmentConfig,
                  dtype=torch.float32, train: bool = True, group_size: int = 1,
                  data_size: int = 1, data_index: int = 0) -> torch.Tensor:
    """Train-mode augmentation with per-sample randomness from ``generator``
    (one draw per ``group_size`` consecutive rows); with ``train=False`` the
    val path, which draws nothing.

    ``images`` are the rows of data index ``data_index`` of a global batch
    ``data_size`` times as large: the draws are made for the global rows and
    the rank keeps its own, so that a row's draw does not depend on the
    mesh's shape (JAX's ``global_batch`` and ``row_offset``)."""
    if not train:
        imgs = images.float()
        if images.dtype == torch.uint8:
            imgs = imgs / 255.0
        return _finalize(val_resize_center_crop(imgs, cfg.size), cfg).to(dtype)
    b, in_h, in_w, _ = images.shape
    return apply_augment(images, draw_rank_rows(generator, b, in_h, in_w, cfg, group_size,
                                                data_size, data_index), cfg, dtype)
