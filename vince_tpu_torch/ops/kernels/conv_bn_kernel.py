"""Fused BN-apply + ReLU + 3×3 convolution + batch-statistic sums (counterpart
of ``vince_tpu/ops/pallas/conv_bn_kernel.py``), a stand-alone op as there: no
model of either package calls it.

    affine_conv3x3_stats(y_prev [N,H,W,C], a [C], b [C], kernel [3,3,C,F])
        -> (y [N,H,W,F] in y_prev's dtype, s1 [F] f32, s2 [F] f32)

with x̂ = relu(y_prev·a + b) computed in f32 and rounded to the dtype,
y = conv3×3(x̂, kernel cast to the dtype) at stride 1 and zero padding 1 with
f32 accumulation, rounded once, and s1 = Σy, s2 = Σy² of the stored (rounded)
y. On a CUDA tensor the forward is ``csrc/affine_conv3x3_stats.cu`` (bf16
only; x̂ never reaches device memory and y is not read again for the sums).
The backward is plain PyTorch, as the JAX VJP is plain XLA: the cotangents of
the sums fold into the output cotangent, two transpose convolutions, and the
strict mask x̂ > 0.

The JAX rule's ``H <= 32`` and 4 MB clauses budget the TPU's VMEM for whole
images per grid step; the CUDA kernel tiles rows and columns over CTAs, so
they are not carried over.
"""

import ctypes
import functools
import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from vince_tpu_torch.ops.kernels import H100_SMS, build, check_tensor, sm_count, use_kernel

_FEATURE_TILE = 128  # output features per CTA
_MAX_POSITIONS = 256  # positions per CTA: four wgmma tiles of 64
_MAX_TILE_COLS = 30
_SMEM_LIMIT = 232448  # shared memory a CTA may use


def kernel_supported(y_prev_shape, kernel_shape, stride=(1, 1), dilation=(1, 1)) -> bool:
    """Stride 1, dilation 1, a 3×3 filter over C % 128 = 0 input channels (the
    kernel stages x̂ in chunks of 128 channels), H >= 2."""
    _, h, _, c = y_prev_shape
    return (tuple(stride) == (1, 1) and tuple(dilation) == (1, 1) and c % 128 == 0
            and tuple(kernel_shape[:3]) == (3, 3, c) and h >= 2)


def _nchw(t):
    return t.permute(0, 3, 1, 2)


def _oihw(kernel):
    return kernel.permute(3, 2, 0, 1)


def _reference(y_prev, a, b, kernel):
    """The plain PyTorch version of the forward."""
    dtype = y_prev.dtype
    xh = torch.relu(y_prev.float() * a + b).to(dtype)
    y = F.conv2d(_nchw(xh), _oihw(kernel.to(dtype)), padding=1).permute(0, 2, 3, 1)
    return (y, torch.sum(y, dim=(0, 1, 2), dtype=torch.float32),
            y.float().square().sum(dim=(0, 1, 2)))


class Tile(NamedTuple):
    rows: int  # th: output rows of a CTA
    cols: int  # tw: output columns of each image
    images: int  # k: images side by side (tw = W where k > 1)


def _halo_rows(positions: int, pw: int) -> int:
    """Rows of the halo the kernel stages: 128 or 256 positions' tiles, then
    the farthest tap (``halo_rows`` in the source)."""
    return math.ceil(((128 if positions <= 128 else 256) + 2 * pw + 2) / 8) * 8


def _smem_bytes(tile: Tile) -> int:
    """The shared memory a CTA of this tile takes, as the source's
    ``smem_bytes`` counts it (``chip_smoke.py`` holds the two equal on the
    card): alignment, 4 filter stages, the halo of 128 channels, 2 staged
    output tiles, the statistics' partials, the barriers."""
    pw = 1 + tile.images * (tile.cols + 1)
    return (1024 + 4 * 16384 + _halo_rows(tile.rows * pw, pw) * 256 + 2 * 64 * 136 * 2
            + 2 * 2 * 8 * 128 * 4 + 64)


def _parts(n: int, h: int, w: int, tile: Tile) -> int:
    """CTAs over the pixels, each with one row of statistics' partials."""
    return math.ceil(n / tile.images) * math.ceil(h / tile.rows) * math.ceil(w / tile.cols)


def _tiles(n: int, h: int, w: int, f: int, sms: int = H100_SMS):
    """Every tile of output pixels a CTA may take, with its score: columns in
    equal tiles of at most 30, then, where a tile is the whole width, k images
    side by side with one zero column between them, and rows in equal bands,
    with rows × (1 + k (columns + 1)) <= 256 and a halo that fits in shared
    memory. The score is the work per SM: waves of CTAs times (wgmma tiles +
    a quarter of the halo rows over 64, the affine pass), then the tiles in
    all, then k."""
    tw = math.ceil(w / math.ceil(w / _MAX_TILE_COLS))
    fchunks = math.ceil(f / _FEATURE_TILE)
    for k in range(1, n + 1) if tw == w else [1]:
        pw = 1 + k * (tw + 1)
        max_rows = _MAX_POSITIONS // pw
        if max_rows < 1:
            break
        tile = Tile(math.ceil(h / math.ceil(h / min(h, max_rows))), tw, k)
        if _smem_bytes(tile) > _SMEM_LIMIT:
            continue
        ctas = _parts(n, h, w, tile) * fchunks
        wgmma_tiles = 2 if tile.rows * pw <= 128 else 4  # one or two a warpgroup
        per_cta = wgmma_tiles + 0.25 * _halo_rows(tile.rows * pw, pw) / 64
        yield (math.ceil(ctas / sms) * per_cta, ctas * wgmma_tiles, k), tile


@functools.lru_cache(maxsize=None)
def _tiling(n: int, h: int, w: int, f: int, sms: int = H100_SMS) -> Tile:
    """The tile of least score (``_tiles``)."""
    best = min(_tiles(n, h, w, f, sms), default=None)
    if best is None:
        raise ValueError(f"no tile fits a CTA at H={h}, W={w}")
    return best[1]


def output_pixels(n: int, h: int, w: int, tile: Tile):
    """(CTA, image, row, column) of each pixel a CTA stores, in the kernel's
    order of CTAs and positions (one slice of features): a Python model of
    the source's index arithmetic."""
    th, tw, k = tile
    pw = 1 + k * (tw + 1)
    ctiles, bands = math.ceil(w / tw), math.ceil(h / th)
    for bid in range(math.ceil(n / k) * bands * ctiles):
        w0 = (bid % ctiles) * tw
        h0 = (bid // ctiles % bands) * th
        n0 = bid // ctiles // bands * k
        for p in range(th * pw):
            hl, wl = divmod(p, pw)
            slot, lc = divmod(wl, tw + 1)
            if lc < tw and slot < k and h0 + hl < h and w0 + lc < w and n0 + slot < n:
                yield bid, n0 + slot, h0 + hl, w0 + lc


@functools.lru_cache(maxsize=None)
def _entry():
    fn = build.load("affine_conv3x3_stats").vince_affine_conv3x3_stats_bf16
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _shapes(y_prev, a, b, kernel):
    """(N, H, W, C, F) of inputs the kernel takes; raises on any other."""
    dev = y_prev.device
    check_tensor(y_prev, "y_prev", torch.bfloat16, 4, dev)
    check_tensor(a, "a", torch.float32, 1, dev)
    check_tensor(b, "b", torch.float32, 1, dev)
    n, h, w, c = y_prev.shape
    if kernel.dim() != 4 or kernel.device != dev:
        raise ValueError(f"kernel must be a 4-D tensor on {dev}")
    f = kernel.shape[3]
    if (a.shape[0] != c or b.shape[0] != c or n == 0 or f == 0
            or not kernel_supported(y_prev.shape, kernel.shape)):
        raise ValueError(f"unsupported shapes y_prev {tuple(y_prev.shape)}, "
                         f"kernel {tuple(kernel.shape)}")
    return n, h, w, c, f


def _launch_with(y_prev, a, b, kernel, tile: Tile):
    """The kernel on the tile ``tile``, uncounted (a measurement may try
    other tiles through it)."""
    n, h, w, c, f = _shapes(y_prev, a, b, kernel)
    dev = y_prev.device
    fp = math.ceil(f / _FEATURE_TILE) * _FEATURE_TILE
    # the filter as [F, 9C] bf16, K-major for TMA: one copy, which casts too
    kt = torch.empty(f, 9 * c, device=dev, dtype=torch.bfloat16).copy_(
        kernel.reshape(9 * c, f).t())
    parts = _parts(n, h, w, tile)
    y = torch.empty(n, h, w, f, device=dev, dtype=torch.bfloat16)
    s1 = torch.empty(f, device=dev, dtype=torch.float32)
    s2 = torch.empty_like(s1)
    s1_part = torch.empty(parts, fp, device=dev, dtype=torch.float32)
    s2_part = torch.empty_like(s1_part)
    status = _entry()(y_prev.data_ptr(), a.data_ptr(), b.data_ptr(), kt.data_ptr(),
                      y.data_ptr(), s1.data_ptr(), s2.data_ptr(), s1_part.data_ptr(),
                      s2_part.data_ptr(), n, h, w, c, f, *tile, parts,
                      torch.cuda.current_stream(dev).cuda_stream)
    build.check(status, "affine_conv3x3_stats")
    return y, s1, s2


def _launch(y_prev, a, b, kernel):
    n, h, w, _, f = _shapes(y_prev, a, b, kernel)
    result = _launch_with(y_prev, a, b, kernel, _tiling(n, h, w, f, sm_count(y_prev.device)))
    affine_conv3x3_stats.launches += 1
    return result


def affine_conv3x3_stats_forward(y_prev, a, b, kernel):
    """The forward: the kernel on a CUDA tensor, the plain version on the CPU."""
    a, b = a.float().contiguous(), b.float().contiguous()
    if use_kernel(y_prev):
        return _launch(y_prev.contiguous(), a, b, kernel)
    affine_conv3x3_stats.plain_calls += 1
    return _reference(y_prev, a, b, kernel.to(y_prev.dtype))


class _AffineConv3x3Stats(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y_prev, a, b, kernel):
        y, s1, s2 = affine_conv3x3_stats_forward(y_prev, a, b, kernel)
        ctx.save_for_backward(y_prev, a, b, kernel, y)
        return y, s1, s2

    @staticmethod
    def backward(ctx, g_y, g_s1, g_s2):
        y_prev, a, b, kernel, y = ctx.saved_tensors
        dtype = y_prev.dtype
        weight = _oihw(kernel.to(dtype))
        # the sums' cotangents fold into y's: ∂Σy/∂y = 1, ∂Σy²/∂y = 2y
        g = g_y.float() + g_s1.float() + 2.0 * y.float() * g_s2.float()
        g = _nchw(g.to(dtype))
        xh32 = torch.relu(y_prev.float() * a + b)
        xh = _nchw(xh32.to(dtype))
        d_xh = torch.nn.grad.conv2d_input(xh.shape, weight, g, padding=1)
        d_weight = torch.nn.grad.conv2d_weight(xh, weight.shape, g, padding=1)
        # strict mask: the derivative of the ReLU is 0 at exactly 0
        t = torch.where(xh32 > 0, d_xh.permute(0, 2, 3, 1).float(), 0.0)
        dy_prev = (t * a).to(dtype)
        da = (t * y_prev.float()).sum(dim=(0, 1, 2))
        db = t.sum(dim=(0, 1, 2))
        return dy_prev, da, db, d_weight.permute(2, 3, 1, 0).to(kernel.dtype)


def affine_conv3x3_stats(y_prev: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                         kernel: torch.Tensor):
    """(y, Σy, Σy²) with y = conv3×3(relu(y_prev·a + b)), stride 1, padding 1;
    ask ``kernel_supported`` first."""
    return _AffineConv3x3Stats.apply(y_prev, a, b, kernel)


affine_conv3x3_stats.launches = 0
affine_conv3x3_stats.plain_calls = 0
