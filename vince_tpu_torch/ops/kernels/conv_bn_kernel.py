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
import math

import torch
import torch.nn.functional as F

from vince_tpu_torch.ops.kernels import build, check_tensor, use_kernel

_FEATURE_TILE = 128  # output features per CTA
_MAX_POSITIONS = 128  # tile rows × (tile columns + 2) per CTA
_MAX_TILE_COLS = 30


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


def _tiling(h: int, w: int):
    """(rows, columns) of a CTA's tile of output pixels: columns in equal
    tiles of at most 30, rows in equal bands with rows × (columns + 2) <= 128."""
    tw = math.ceil(w / math.ceil(w / _MAX_TILE_COLS))
    max_rows = _MAX_POSITIONS // (tw + 2)
    return math.ceil(h / math.ceil(h / max_rows)), tw


def _launch(y_prev, a, b, kernel):
    dev = y_prev.device
    check_tensor(y_prev, "y_prev", torch.bfloat16, 4, dev)
    check_tensor(a, "a", torch.float32, 1, dev)
    check_tensor(b, "b", torch.float32, 1, dev)
    check_tensor(kernel, "kernel", torch.bfloat16, 4, dev)
    n, h, w, c = y_prev.shape
    f = kernel.shape[3]
    if (a.shape[0] != c or b.shape[0] != c or n == 0 or f == 0
            or not kernel_supported(y_prev.shape, kernel.shape)):
        raise ValueError(f"unsupported shapes y_prev {tuple(y_prev.shape)}, "
                         f"kernel {tuple(kernel.shape)}")
    fp = math.ceil(f / _FEATURE_TILE) * _FEATURE_TILE
    kmat = kernel.reshape(9 * c, f)
    if fp != f:  # zero columns, so that a CTA's filter slabs need no mask
        kmat = F.pad(kmat, (0, fp - f))
    th, tw = _tiling(h, w)
    parts = n * math.ceil(h / th) * math.ceil(w / tw)
    y = torch.empty(n, h, w, f, device=dev, dtype=torch.bfloat16)
    s1 = torch.empty(f, device=dev, dtype=torch.float32)
    s2 = torch.empty_like(s1)
    s1_part = torch.empty(parts, fp, device=dev, dtype=torch.float32)
    s2_part = torch.empty_like(s1_part)
    fn = build.load("affine_conv3x3_stats").vince_affine_conv3x3_stats_bf16
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    status = fn(y_prev.data_ptr(), a.data_ptr(), b.data_ptr(), kmat.data_ptr(), y.data_ptr(),
                s1.data_ptr(), s2.data_ptr(), s1_part.data_ptr(), s2_part.data_ptr(),
                n, h, w, c, f, fp, th, tw, torch.cuda.current_stream(dev).cuda_stream)
    build.check(status, "affine_conv3x3_stats")
    affine_conv3x3_stats.launches += 1
    return y, s1, s2


def affine_conv3x3_stats_forward(y_prev, a, b, kernel):
    """The forward: the kernel on a CUDA tensor, the plain version on the CPU."""
    a, b = a.float().contiguous(), b.float().contiguous()
    kernel = kernel.to(y_prev.dtype).contiguous()
    if use_kernel(y_prev):
        return _launch(y_prev.contiguous(), a, b, kernel)
    affine_conv3x3_stats.plain_calls += 1
    return _reference(y_prev, a, b, kernel)


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
