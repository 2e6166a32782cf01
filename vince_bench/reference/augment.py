"""The train-mode augmentation of a VINCE step, in plain float32 PyTorch.

Two parts, kept apart:

- ``draw``: every random number of one call, made from a ``torch.Generator``
  in the port's order of calls (torchvision's ``RandomResizedCrop.get_params``
  with 10 tries, the flip, the jitter's factors and order, grayscale, blur).
  This order is all that the reference shares with the port: the same seed
  then gives the same numbers on the same device.
- ``apply``: the transforms, written here from their published semantics,
  one operation at a time, with no code of the port's. The crop box is
  resampled bilinearly at half-pixel centres with the coordinates held to
  the frame, and flipped; colour jitter is torchvision's on float tensors
  (brightness, contrast and saturation as blends, hue through HSV with
  torchvision's conversions), in each row's drawn order; grayscale takes
  PIL's ``convert("L")`` weights (ITU-R 601-2), as the reference's PIL
  pipeline did; the gaussian blur's kernel spans ``blur_kernel`` taps and is
  renormalised over the taps that fall inside the frame. Where these differ
  from torchvision's tensor functions (a crop sampled only inside its box,
  a blur with reflected edges), they follow the port's stated design, which
  the benchmark holds it to.

A transform's parameters are a data file, ``reference/transforms/<name>.json``,
named by the configuration's ``transform``.
"""

import dataclasses
import json
import math
from pathlib import Path
from typing import Tuple

import torch

TRANSFORMS_DIR = Path(__file__).resolve().parent / "transforms"
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
LUMA = (0.299, 0.587, 0.114)  # PIL's convert("L")


@dataclasses.dataclass(frozen=True)
class Transform:
    size: Tuple[int, int]
    crop_scale: Tuple[float, float]
    crop_ratio: Tuple[float, float]
    brightness: float
    contrast: float
    saturation: float
    hue: float
    color_jitter_prob: float
    grayscale_prob: float
    hflip_prob: float
    blur_prob: float
    blur_sigma: Tuple[float, float]

    @property
    def blur_kernel(self) -> int:
        """Taps of the blur: a tenth of the side, at least 3, odd."""
        k = max(self.size[0] // 10, 3)
        return k + 1 - (k % 2)


def transform(name: str, size: int) -> Transform:
    """The transform of ``transforms/<name>.json`` at ``size``² pixels."""
    path = TRANSFORMS_DIR / f"{name}.json"
    if not path.is_file():
        raise KeyError(f"no reference transform {name!r} ({path.name} is not there)")
    spec = json.loads(path.read_text())
    fields = {f.name for f in dataclasses.fields(Transform)} - {"size"}
    return Transform(size=(size, size), **{k: tuple(v) if isinstance(v, list) else v
                                           for k, v in spec.items() if k in fields})


def draw(gen: torch.Generator, batch: int, in_h: int, in_w: int, cfg: Transform) -> dict:
    """Every random number of one train-mode augmentation of ``batch`` rows,
    in the port's order of generator calls."""
    dev = gen.device

    def uniform(lo=0.0, hi=1.0, shape=(batch,)):
        return torch.rand(*shape, generator=gen, device=dev) * (hi - lo) + lo

    # torchvision's RandomResizedCrop.get_params: 10 tries, the first valid
    area = float(in_h * in_w)
    target = area * uniform(*cfg.crop_scale, shape=(batch, 10))
    aspect = torch.exp(uniform(math.log(cfg.crop_ratio[0]), math.log(cfg.crop_ratio[1]),
                               shape=(batch, 10)))
    w = torch.round(torch.sqrt(target * aspect))
    h = torch.round(torch.sqrt(target / aspect))
    valid = (w > 0) & (w <= in_w) & (h > 0) & (h <= in_h)
    first = valid.float().argmax(dim=1, keepdim=True)
    any_valid = valid.any(dim=1)
    sel_h, sel_w = h.gather(1, first)[:, 0], w.gather(1, first)[:, 0]
    u_i = uniform(shape=(batch, 10)).gather(1, first)[:, 0]
    u_j = uniform(shape=(batch, 10)).gather(1, first)[:, 0]
    i = torch.floor(u_i * (in_h - sel_h + 1))
    j = torch.floor(u_j * (in_w - sel_w + 1))
    ratio = in_w / in_h
    if ratio < cfg.crop_ratio[0]:
        fb_w, fb_h = float(in_w), float(round(in_w / cfg.crop_ratio[0]))
    elif ratio > cfg.crop_ratio[1]:
        fb_w, fb_h = float(round(in_h * cfg.crop_ratio[1])), float(in_h)
    else:
        fb_w, fb_h = float(in_w), float(in_h)
    out = dict(crop_i=torch.where(any_valid, i, (in_h - fb_h) // 2),
               crop_j=torch.where(any_valid, j, (in_w - fb_w) // 2),
               crop_h=torch.where(any_valid, sel_h, fb_h),
               crop_w=torch.where(any_valid, sel_w, fb_w))
    out["flip"] = uniform() < cfg.hflip_prob
    jitter = out["jitter"] = uniform() < cfg.color_jitter_prob
    ones = torch.ones(batch, device=dev)

    def factor(strength):
        return torch.where(jitter, uniform(max(0.0, 1.0 - strength), 1.0 + strength), 1.0)

    out["fb"] = factor(cfg.brightness) if cfg.brightness else ones
    out["fc"] = factor(cfg.contrast) if cfg.contrast else ones
    out["fs"] = factor(cfg.saturation) if cfg.saturation else ones
    out["fh"] = torch.where(jitter, uniform(-cfg.hue, cfg.hue), 0.0) if cfg.hue else 0 * ones
    out["perm"] = torch.argsort(uniform(shape=(batch, 4)), dim=1)
    out["gray"] = uniform() < cfg.grayscale_prob
    out["blur"] = uniform() < cfg.blur_prob
    out["sigma"] = uniform(*cfg.blur_sigma)
    return out


# ---------------------------------------------------------------- geometry


def _taps(start, extent, out: int, limit: int):
    """For each row and output index, the two source indices and the weight
    of the second: the point ``start + (i + ½)·extent/out − ½``, held to
    [0, limit − 1]."""
    i = torch.arange(out, dtype=torch.float32, device=start.device)
    x = (start[:, None] + (i[None, :] + 0.5) * (extent[:, None] / out) - 0.5)
    x = x.clamp(0.0, limit - 1.0)
    lo = torch.floor(x)
    frac = x - lo
    lo = lo.long()
    return lo, (lo + 1).clamp(max=limit - 1), frac


def resized_crop(img, top, left, height, width, size: Tuple[int, int], flip):
    """[B, H, W, C] → [B, size, C]: each row's box sampled bilinearly, then
    mirrored left to right where ``flip``."""
    b, in_h, in_w, _ = img.shape
    rows = torch.arange(b, device=img.device)
    y0, y1, fy = _taps(top, height, size[0], in_h)
    x0, x1, fx = _taps(left, width, size[1], in_w)
    fy, fx = fy[:, :, None, None], fx[:, None, :, None]
    r = rows[:, None]
    tall = img[r, y0] * (1.0 - fy) + img[r, y1] * fy  # [B, out_h, W, C]
    r = rows[:, None, None]
    oy = torch.arange(size[0], device=img.device)[None, :, None]
    out = tall[r, oy, x0[:, None, :]] * (1.0 - fx) + tall[r, oy, x1[:, None, :]] * fx
    return torch.where(flip[:, None, None, None], out.flip(2), out)


def gaussian_blur(img, sigma, kernel: int):
    """Each row blurred by a separable gaussian of its ``sigma`` over
    ``kernel`` taps, the taps that fall outside the frame left out and the
    rest renormalised."""
    half = (kernel - 1) // 2
    offsets = torch.arange(-half, half + 1, dtype=torch.float32, device=img.device)
    taps = torch.exp(-0.5 * (offsets[None, :] / sigma[:, None]) ** 2)  # [B, K]

    def along(x, dim):
        n = x.shape[dim]
        ones = torch.ones_like(x.narrow(-1, 0, 1))
        acc, weight = torch.zeros_like(x), torch.zeros_like(ones)
        for k, d in enumerate(range(-half, half + 1)):
            if abs(d) >= n:
                continue
            t = taps[:, k].view(-1, *([1] * (x.dim() - 1)))
            lo, hi = max(0, -d), n - max(0, d)  # output indices whose source i + d is inside
            acc.narrow(dim, lo, hi - lo).add_(t * x.narrow(dim, lo + d, hi - lo))
            weight.narrow(dim, lo, hi - lo).add_(t * ones.narrow(dim, lo + d, hi - lo))
        return acc / weight

    return along(along(img, 1), 2)


# ---------------------------------------------------------------- colour


def grayscale(img):
    """[..., 3] → [..., 1] luma."""
    r, g, b = img.unbind(-1)
    return (LUMA[0] * r + LUMA[1] * g + LUMA[2] * b)[..., None]


def _blend(img, other, ratio):
    """torchvision's ``_blend`` on float images: ratio·img + (1 − ratio)·other,
    clamped to [0, 1]."""
    ratio = ratio.view(-1, 1, 1, 1)
    return (ratio * img + (1.0 - ratio) * other).clamp(0.0, 1.0)


def adjust_brightness(img, f):
    return _blend(img, torch.zeros_like(img), f)


def adjust_contrast(img, f):
    return _blend(img, grayscale(img).mean(dim=(1, 2, 3), keepdim=True), f)


def adjust_saturation(img, f):
    return _blend(img, grayscale(img), f)


def rgb_to_hsv(img):
    """torchvision's ``_rgb2hsv``, channels last."""
    r, g, b = img.unbind(-1)
    maxc = img.amax(dim=-1)
    minc = img.amin(dim=-1)
    eqc = maxc == minc
    cr = maxc - minc
    ones = torch.ones_like(maxc)
    s = cr / torch.where(eqc, ones, maxc)
    div = torch.where(eqc, ones, cr)
    rc, gc, bc = (maxc - r) / div, (maxc - g) / div, (maxc - b) / div
    hr = (maxc == r) * (bc - gc)
    hg = ((maxc == g) & (maxc != r)) * (2.0 + rc - bc)
    hb = ((maxc != g) & (maxc != r)) * (4.0 + gc - rc)
    h = torch.fmod((hr + hg + hb) / 6.0 + 1.0, 1.0)
    return torch.stack((h, s, maxc), dim=-1)


def hsv_to_rgb(hsv):
    """torchvision's ``_hsv2rgb``, channels last; the sector picked by index."""
    h, s, v = hsv.unbind(-1)
    i = torch.floor(h * 6.0)
    f = h * 6.0 - i
    i = torch.remainder(i.long(), 6)
    p = (v * (1.0 - s)).clamp(0.0, 1.0)
    q = (v * (1.0 - s * f)).clamp(0.0, 1.0)
    t = (v * (1.0 - s * (1.0 - f))).clamp(0.0, 1.0)
    sectors = (torch.stack((v, q, p, p, t, v), dim=-1), torch.stack((t, v, v, q, p, p), dim=-1),
               torch.stack((p, p, t, v, v, q), dim=-1))
    return torch.stack([c.gather(-1, i[..., None])[..., 0] for c in sectors], dim=-1)


def adjust_hue(img, shift):
    hsv = rgb_to_hsv(img)
    h = torch.remainder(hsv[..., 0] + shift.view(-1, 1, 1), 1.0)
    return hsv_to_rgb(torch.stack((h, hsv[..., 1], hsv[..., 2]), dim=-1))


def color_jitter(img, d):
    """Each jittered row through brightness (0), contrast (1), saturation (2)
    and hue (3) in its drawn order ``perm``; the other rows unchanged."""
    ops = ((adjust_brightness, d["fb"]), (adjust_contrast, d["fc"]),
           (adjust_saturation, d["fs"]), (adjust_hue, d["fh"]))
    for position in range(4):
        for op, (fn, factor) in enumerate(ops):
            rows = d["jitter"] & (d["perm"][:, position] == op)
            if bool(rows.any()):
                img = torch.where(rows[:, None, None, None], fn(img, factor), img)
    return img


def apply(images: torch.Tensor, d: dict, cfg: Transform) -> torch.Tensor:
    """uint8 [B, H, W, 3] → normalised float32 [B, size, size, 3]: crop and
    flip, colour jitter, grayscale, blur, ImageNet's mean and deviation."""
    out = resized_crop(images.float() / 255.0, d["crop_i"], d["crop_j"], d["crop_h"],
                       d["crop_w"], cfg.size, d["flip"]).clamp(0.0, 1.0)
    if cfg.brightness or cfg.contrast or cfg.saturation or cfg.hue:
        out = color_jitter(out, d)
    if cfg.grayscale_prob > 0:
        out = torch.where(d["gray"][:, None, None, None], grayscale(out).expand_as(out), out)
    if cfg.blur_prob > 0:
        out = torch.where(d["blur"][:, None, None, None],
                          gaussian_blur(out, d["sigma"], cfg.blur_kernel), out)
    mean = torch.tensor(IMAGENET_MEAN, device=out.device)
    std = torch.tensor(IMAGENET_STD, device=out.device)
    return (out - mean) / std
