"""Fused BN-apply + ReLU + 1×1 dot + input moments (counterpart of
``vince_tpu/ops/pallas/folded_dot_kernel.py``).

    affine_relu_dot_moments(y [M,C], a [C], b [C], w [C,F])
        -> (out [M,F] in y's dtype, s1 [C] f32, s2 [C,C] f32)

with x̂ = relu(a·y + b): out = x̂@W from the x̂ rounded to y's dtype, s1 = Σx̂
from the f32 x̂, s2 = x̂ᵀx̂ from the rounded x̂ with f32 accumulation. On a
CUDA tensor the forward is ``csrc/affine_relu_dot_moments.cu`` (bf16 only; x̂
never reaches device memory); the backward is plain PyTorch, as the JAX VJP is
plain XLA, and recomputes x̂.
"""

import ctypes
import math

import torch

from vince_tpu_torch.ops.kernels import build, check_tensor, use_kernel

_MAIN_ROWS = 64
_MOMENT_ROWS = 64
_TILE = 128
_TARGET_CTAS = 132  # moment CTAs: one per SM of the H100


def _reference(y, a, b, w):
    """The plain PyTorch version of the forward."""
    xh32 = torch.relu(y.float() * a + b)
    xh = xh32.to(y.dtype)
    out = xh @ w.to(y.dtype)
    xf = xh.float()
    return out, xh32.sum(dim=0), xf.T @ xf


def kernel_supported(m: int, c: int, f: int) -> bool:
    """The kernel keeps a [64, C] block of x̂ in shared memory, so C stops at
    1024; the JAX kernel has no such limit."""
    return c % 128 == 0 and c <= 1024 and f % 128 == 0 and m > 0


def _split(m: int, c: int):
    t = c // _TILE
    pairs = t * (t + 1) // 2
    msplit = max(1, min(math.ceil(m / _MOMENT_ROWS), math.ceil(_TARGET_CTAS / pairs)))
    rows = math.ceil(math.ceil(m / msplit) / _MOMENT_ROWS) * _MOMENT_ROWS
    return math.ceil(m / rows), rows


def _launch(y, a, b, w):
    dev = y.device
    check_tensor(y, "y", torch.bfloat16, 2, dev)
    check_tensor(a, "a", torch.float32, 1, dev)
    check_tensor(b, "b", torch.float32, 1, dev)
    check_tensor(w, "w", torch.bfloat16, 2, dev)
    m, c = y.shape
    f = w.shape[1]
    if a.shape[0] != c or b.shape[0] != c or w.shape[0] != c or not kernel_supported(m, c, f):
        raise ValueError(f"unsupported shapes y {tuple(y.shape)}, w {tuple(w.shape)}")
    msplit, rows = _split(m, c)
    out = torch.empty(m, f, device=dev, dtype=torch.bfloat16)
    s1 = torch.empty(c, device=dev, dtype=torch.float32)
    s2 = torch.empty(c, c, device=dev, dtype=torch.float32)
    s1_part = torch.empty(math.ceil(m / _MAIN_ROWS), c, device=dev, dtype=torch.float32)
    s2_part = torch.empty(msplit, c, c, device=dev, dtype=torch.float32)
    fn = build.load("affine_relu_dot_moments").vince_affine_relu_dot_moments_bf16
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    status = fn(y.data_ptr(), a.data_ptr(), b.data_ptr(), w.data_ptr(), out.data_ptr(),
                s1.data_ptr(), s2.data_ptr(), s1_part.data_ptr(), s2_part.data_ptr(),
                m, c, f, msplit, rows, torch.cuda.current_stream(dev).cuda_stream)
    build.check(status, "affine_relu_dot_moments")
    affine_relu_dot_moments.launches += 1
    return out, s1, s2


def affine_relu_dot_moments_forward(y, a, b, w):
    """The forward: the kernel on a CUDA tensor, the plain version on the CPU."""
    a, b = a.float().contiguous(), b.float().contiguous()
    w = w.to(y.dtype).contiguous()
    if use_kernel(y):
        return _launch(y.contiguous(), a, b, w)
    affine_relu_dot_moments.plain_calls += 1
    return _reference(y, a, b, w)


class _AffineReluDotMoments(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, a, b, w):
        ctx.save_for_backward(y, a, b, w)
        return affine_relu_dot_moments_forward(y, a, b, w)

    @staticmethod
    def backward(ctx, g_out, g_s1, g_s2):
        y, a, b, w = ctx.saved_tensors
        dtype = y.dtype
        xh32 = torch.relu(y.float() * a + b)
        xh = xh32.to(dtype)
        # d x̂ from the three outputs; s2 = x̂ᵀx̂ is symmetric-bilinear in x̂
        g_xh = (g_out.to(dtype) @ w.to(dtype).T).float()
        if g_s1 is not None:
            g_xh = g_xh + g_s1.float()[None, :]
        if g_s2 is not None:
            g_xh = g_xh + (xh @ (g_s2 + g_s2.T).to(dtype)).float()
        t = torch.where(xh32 > 0, g_xh, 0.0)
        dy = (t * a).to(dtype)
        da = (t * y.float()).sum(dim=0)
        db = t.sum(dim=0)
        dw = (xh.float().T @ g_out.float()).to(w.dtype)
        return dy, da, db, dw


def affine_relu_dot_moments(y: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                            w: torch.Tensor):
    """(x̂@W, Σx̂, x̂ᵀx̂) with x̂ = relu(y·a + b), in one pass over y."""
    return _AffineReluDotMoments.apply(y, a, b, w)


affine_relu_dot_moments.launches = 0
affine_relu_dot_moments.plain_calls = 0
