"""Batched image augmentation on the device, train path (counterpart of
``vince_tpu/ops/augment.py``).

The random numbers are drawn in one function (``draw_augment_params``, from
a ``torch.Generator``) and applied by a deterministic one
(``apply_augment``), so a test can feed the JAX and the PyTorch pipelines the
same draws. The geometric ops (random resized crop, horizontal flip, gaussian
blur) are per-sample separable linear operators applied as two batched
matmuls, ``out = W_y · img · W_xᵀ``: the JAX package records a gather
formulation as a 500× regression. Colour jitter follows torchvision's
float-tensor semantics with a per-sample random op order and one HSV pass.
"""

import dataclasses
import math
from typing import Tuple

import torch

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
_GRAY_WEIGHTS = (0.299, 0.587, 0.114)  # ITU-R 601-2 luma, as PIL convert("L")


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
    fb: torch.Tensor  # brightness / contrast / saturation blend factors
    fc: torch.Tensor
    fs: torch.Tensor
    fh: torch.Tensor  # hue shift in turns
    perm: torch.Tensor  # int64 per-sample op order of (b, c, s, hue)
    gray: torch.Tensor  # bool
    blur: torch.Tensor  # bool
    sigma: torch.Tensor


# ---------------------------------------------------------------------------
# colour helpers


def _rgb_to_grayscale(img):
    w = torch.tensor(_GRAY_WEIGHTS, dtype=img.dtype, device=img.device)
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


def _finalize(out, cfg: AugmentConfig):
    if cfg.normalize:
        mean = torch.tensor(IMAGENET_MEAN, dtype=out.dtype, device=out.device)
        std = torch.tensor(IMAGENET_STD, dtype=out.dtype, device=out.device)
        out = (out - mean) / std
    return out


# ---------------------------------------------------------------------------
# the pipeline


def draw_augment_params(generator: torch.Generator, batch: int, in_h: int, in_w: int,
                        cfg: AugmentConfig) -> AugmentDraws:
    """Every random number of one train-mode call, from ``generator`` on its device."""
    if cfg.jitter_order != "torchvision":
        raise ValueError(f"jitter_order={cfg.jitter_order!r} is not ported")
    dev = generator.device

    def uniform(lo=0.0, hi=1.0, shape=(batch,)):
        return torch.rand(*shape, generator=generator, device=dev) * (hi - lo) + lo

    crop = sample_crop_boxes(generator, batch, in_h, in_w, cfg)
    flip = uniform() < cfg.hflip_prob
    jitter = uniform() < cfg.color_jitter_prob

    def factor(strength):
        return torch.where(jitter, uniform(max(0.0, 1.0 - strength), 1.0 + strength), 1.0)

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


def augment_batch(generator: torch.Generator, images: torch.Tensor, cfg: AugmentConfig,
                  dtype=torch.float32) -> torch.Tensor:
    """Train-mode augmentation with per-sample randomness from ``generator``."""
    b, in_h, in_w, _ = images.shape
    return apply_augment(images, draw_augment_params(generator, b, in_h, in_w, cfg),
                         cfg, dtype)
