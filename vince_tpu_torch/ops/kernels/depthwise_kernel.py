"""Stride-1 depthwise convolution for the EfficientNet MBConv blocks
(counterpart of ``vince_tpu/ops/pallas/depthwise_kernel.py``).

    depthwise_conv(x [N,H,W,C], w [k,k,1,C]) -> [N,H,W,C] in x's dtype

stride 1, k in {3, 5}, zero padding (k-1)/2 on every side, NHWC. ``w`` is cast
to x's dtype, every tap and weight is widened to f32, the k² products and
their sum (row-major: i, then j) are f32, and the sum is rounded once to x's
dtype. On a CUDA tensor the forward is ``csrc/depthwise_conv.cu`` (bf16 or
f32), and so is the backward's dx: the same kernel on the cotangent with the
filter flipped in both spatial dimensions. dw is k² shifted multiply-reduces,
the product in x's dtype and the sum in f32, as the JAX VJP computes it in
XLA outside its Pallas kernel; here a second hand-written kernel of the same
source computes all k² of them in one pass over x and the cotangent
(``depthwise_wgrad``), because in eager PyTorch they are 2k² passes.

The forward kernel rounds each product and then adds it (no fma), in the
plain version's order, so on the card it equals ``_reference`` bit for bit.
The wgrad kernel rounds each product as its plain version does and sums in
f32 in another (fixed) order.

The JAX rule also turns away an image that does not fit the TPU's scoped VMEM
at 128-lane padding. That is no limit of a GPU: the CUDA kernel tiles rows,
columns and channels over CTAs and takes any N, H, W, C. The port therefore
runs EfficientNet-B0's first depthwise site (block_0: 112x112, C = 32)
through the kernel, where the JAX package sends it to XLA's grouped
convolution.
"""

import ctypes

import torch
import torch.nn.functional as F

from vince_tpu_torch.ops.kernels import build, check_tensor, use_kernel

_THREADS = 256
_BAND_ROWS = 28  # output rows a CTA walks down: it re-reads k-1 of band+k-1 input rows


def kernel_supported(x_shape, k: int, stride: int) -> bool:
    """Stride 1, k in {3, 5}, and an image at least as large as the filter."""
    _, h, w, _ = x_shape
    return stride == 1 and k in (3, 5) and h >= k and w >= k


def _reference(x, w):
    """The plain PyTorch version: k² shifted multiply-adds in f32, each tap
    and weight widened first, as the kernel computes them. It is not the
    ``tap`` emission of ``models/efficientnet.py`` (``_tap_sum``), which
    multiplies in x's dtype and widens the product."""
    k = w.shape[0]
    p = (k - 1) // 2
    h, wd = x.shape[1], x.shape[2]
    wf = w.to(x.dtype).float()
    xp = F.pad(x, (0, 0, p, p, p, p)).float()
    acc = torch.zeros_like(x, dtype=torch.float32)
    for i in range(k):
        for j in range(k):
            acc = acc + xp[:, i:i + h, j:j + wd, :] * wf[i, j, 0]
    return acc.to(x.dtype)


def _tiling(h: int, w: int, c: int, max_vec: int):
    """(channels per thread, channel vectors per CTA, rows per band). A thread
    holds the most channels up to ``max_vec`` that divide C. A CTA of 256
    threads is tcv channel vectors by 256/tcv columns: 16 columns where the
    image has them, so that most column taps are another thread's own column,
    more where C is narrow. Rows go in equal bands of at most 28."""
    vec = max(v for v in (1, 2, 4) if v <= max_vec and c % v == 0)
    cols = tcv = 1
    while cols < min(w, 16):
        cols *= 2
    while tcv < min(c // vec, _THREADS // cols):
        tcv *= 2
    bands = -(-h // _BAND_ROWS)
    return vec, tcv, -(-h // bands)


def _launch(x, w):
    dev = x.device
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"x has dtype {x.dtype}, expected bfloat16 or float32")
    check_tensor(x, "x", x.dtype, 4, dev)
    check_tensor(w, "w", x.dtype, 4, dev)
    n, h, wd, c = x.shape
    k = w.shape[0]
    if tuple(w.shape) != (k, k, 1, c) or not kernel_supported(x.shape, k, 1) or n == 0 or c == 0:
        raise ValueError(f"unsupported shapes x {tuple(x.shape)}, w {tuple(w.shape)}")
    out = torch.empty_like(x)
    vec, tcv, band_rows = _tiling(h, wd, c, 2)
    fn = build.load("depthwise_conv").vince_depthwise_conv
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    status = fn(x.data_ptr(), w.data_ptr(), out.data_ptr(), n, h, wd, c, k,
                int(x.dtype == torch.bfloat16), vec, tcv, band_rows,
                torch.cuda.current_stream(dev).cuda_stream)
    build.check(status, "depthwise_conv")
    depthwise_conv.launches += 1
    return out


def depthwise_conv_forward(x, w):
    """The forward: the kernel on a CUDA tensor, the plain version on the CPU."""
    w = w.to(x.dtype).contiguous()
    if use_kernel(x):
        return _launch(x.contiguous(), w)
    depthwise_conv.plain_calls += 1
    return _reference(x, w)


def _reference_wgrad(x, g, k: int):
    """The plain PyTorch version of the filter gradient [k,k,1,C] f32: for each
    tap the shifted x times g, the product in x's dtype and its sum over N, H,
    W in f32."""
    h, wd = x.shape[1], x.shape[2]
    p = (k - 1) // 2
    xp = F.pad(x, (0, 0, p, p, p, p))
    taps = [torch.sum(xp[:, i:i + h, j:j + wd, :] * g, dim=(0, 1, 2), dtype=torch.float32)
            for i in range(k) for j in range(k)]
    return torch.stack(taps).reshape(k, k, 1, -1)


def _launch_wgrad(x, g, k: int):
    dev = x.device
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"x has dtype {x.dtype}, expected bfloat16 or float32")
    check_tensor(x, "x", x.dtype, 4, dev)
    check_tensor(g, "g", x.dtype, 4, dev)
    n, h, wd, c = x.shape
    if g.shape != x.shape or not kernel_supported(x.shape, k, 1) or n == 0 or c == 0:
        raise ValueError(f"unsupported shapes x {tuple(x.shape)}, g {tuple(g.shape)}, k {k}")
    # four channels a thread where k=3; k=5's 25 sums per channel fill the registers
    vec, tcv, band_rows = _tiling(h, wd, c, 4 if k == 3 else 2)
    part = torch.empty(n * -(-h // band_rows), k * k, c, device=dev, dtype=torch.float32)
    dw = torch.empty(k, k, 1, c, device=dev, dtype=torch.float32)
    fn = build.load("depthwise_conv").vince_depthwise_wgrad
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    status = fn(x.data_ptr(), g.data_ptr(), part.data_ptr(), dw.data_ptr(), n, h, wd, c, k,
                int(x.dtype == torch.bfloat16), vec, tcv, band_rows,
                torch.cuda.current_stream(dev).cuda_stream)
    build.check(status, "depthwise_wgrad")
    depthwise_wgrad.launches += 1
    return dw


def depthwise_wgrad(x, g, k: int):
    """dL/dw [k,k,1,C] f32 of the stride-1 depthwise conv from its input x and
    output cotangent g (both [N,H,W,C], g in x's dtype): the kernel on a CUDA
    tensor, the plain version on the CPU."""
    if use_kernel(x):
        return _launch_wgrad(x.contiguous(), g.contiguous(), k)
    depthwise_wgrad.plain_calls += 1
    return _reference_wgrad(x, g, k)


class _DepthwiseConv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return depthwise_conv_forward(x, w)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        dx = dw = None
        if ctx.needs_input_grad[0]:
            # stride 1 with symmetric padding: dgrad is the same convolution
            # with the taps flipped (a contiguous copy: the kernel takes a pointer)
            dx = depthwise_conv_forward(g.to(x.dtype), w.flip(0, 1))
        if ctx.needs_input_grad[1]:
            dw = depthwise_wgrad(x, g.to(x.dtype), w.shape[0]).to(w.dtype)
        return dx, dw


def depthwise_conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Stride-1 depthwise conv of x [N,H,W,C] with w [k,k,1,C], zero padding
    (k-1)/2; ask ``kernel_supported`` first."""
    return _DepthwiseConv.apply(x, w)


depthwise_conv.launches = 0
depthwise_conv.plain_calls = 0
depthwise_wgrad.launches = 0
depthwise_wgrad.plain_calls = 0
