"""Fused BN-apply + ReLU + 1×1 dot + input moments (counterpart of
``vince_tpu/ops/pallas/folded_dot_kernel.py``).

    affine_relu_dot_moments(y [M,C], a [C], b [C], w [C,F])
        -> (out [M,F] in y's dtype, s1 [C] f32, s2 [C,C] f32)

with x̂ = relu(a·y + b): out = x̂@W from the x̂ rounded to y's dtype, s1 = Σx̂
from the f32 x̂, s2 = x̂ᵀx̂ from the rounded x̂ with f32 accumulation. On a
CUDA tensor the forward is ``csrc/affine_relu_dot_moments.cu`` (bf16 only; x̂
never reaches device memory; ``plan`` is its schedule, and ``main_tiles``
and ``moment_tiles`` model in Python the tiles that the kernel's index
arithmetic gives each CTA); the backward is plain PyTorch, as the JAX VJP
is plain XLA, and recomputes x̂.
"""

import ctypes
import functools
import math
from typing import NamedTuple

import torch

from vince_tpu_torch.ops.kernels import H100_SMS, build, check_tensor, sm_count, use_kernel

_BLOCK_ROWS = 128  # rows of a main-kernel work item: two warpgroups of 64
_BN = 128  # output columns per F chunk
_SC_MAX = 512  # channels of x̂ the main kernel keeps in shared memory
_MOMENT_ROWS = 64  # rows per step of the moments loop
_TILE = 128  # s2 tile edge


def _reference(y, a, b, w):
    """The plain PyTorch version of the forward."""
    xh32 = torch.relu(y.float() * a + b)
    xh = xh32.to(y.dtype)
    out = xh @ w.to(y.dtype)
    xf = xh.float()
    return out, xh32.sum(dim=0), xf.T @ xf


def kernel_supported(m: int, c: int, f: int) -> bool:
    """C and F multiples of 128, as the JAX rule asks; any C (above 512 the
    kernel rebuilds x̂ for each F chunk instead of keeping it)."""
    return c % 128 == 0 and f % 128 == 0 and m > 0


class Plan(NamedTuple):
    grid: int  # persistent main-kernel CTAs
    fsplit: int  # F is split over this many work items per row block
    sc: int  # channels of x̂ built at once (C where C <= 512)
    msplit: int  # row splits of each s2 tile
    rows: int  # rows per split, a multiple of 64


def _super_chunk(c: int) -> int:
    if c <= _SC_MAX:
        return c
    return max(s for s in range(_TILE, _SC_MAX + 1, _TILE) if c % s == 0)


def _fsplit(m: int, f: int, sms: int) -> int:
    """The split of F that evens out the CTAs' work: the largest number of F
    chunks a CTA walks, plus two chunks' time for each x̂ it builds (what the
    sweeps of ``tools/fold_conv_sweeps.py`` on the H100 fit)."""
    blocks, chunks = math.ceil(m / _BLOCK_ROWS), f // _BN
    splits = [d for d in range(1, chunks + 1) if chunks % d == 0]
    return min(splits, key=lambda d: (math.ceil(blocks * d / sms) * (chunks / d + 2), d))


def _split(m: int, c: int, sms: int):
    """Row splits of each s2 tile: about one moments CTA per SM."""
    t = c // _TILE
    pairs = t * (t + 1) // 2
    msplit = max(1, min(math.ceil(m / _MOMENT_ROWS), math.ceil(sms / pairs)))
    rows = math.ceil(math.ceil(m / msplit) / _MOMENT_ROWS) * _MOMENT_ROWS
    return math.ceil(m / rows), rows


def plan(m: int, c: int, f: int, sms: int = H100_SMS) -> Plan:
    fsplit = _fsplit(m, f, sms)
    items = math.ceil(m / _BLOCK_ROWS) * fsplit
    return Plan(min(items, sms), fsplit, _super_chunk(c), *_split(m, c, sms))


def main_tiles(m: int, f: int, p: Plan):
    """The [rows, columns] tiles of ``out`` that the main kernel stores, in
    its order: CTA, work item, F chunk, warpgroup."""
    items = math.ceil(m / _BLOCK_ROWS) * p.fsplit
    chunks = f // _BN // p.fsplit
    for cta in range(p.grid):
        for it in range(cta, items, p.grid):
            rb, fs = divmod(it, p.fsplit)
            for fc in range(chunks):
                f0 = (fs * chunks + fc) * _BN
                for wg in range(2):
                    r0 = rb * _BLOCK_ROWS + wg * 64
                    if r0 < m:
                        yield (r0, min(r0 + 64, m)), (f0, f0 + _BN)


def moment_tiles(m: int, c: int, p: Plan):
    """(split, rows, s2 rows, s2 columns, mirrored) of each moments CTA's
    warpgroup, and the s1 channels the diagonal CTAs sum."""
    t = c // _TILE
    pairs = [(i, j) for i in range(t) for j in range(i, t)]
    for split in range(p.msplit):
        rows = (split * p.rows, min(m, (split + 1) * p.rows))
        for ti, tj in pairs:
            for wg in range(2):
                r0 = ti * _TILE + wg * 64
                yield split, rows, (r0, r0 + 64), (tj * _TILE, tj * _TILE + _TILE), ti != tj


@functools.lru_cache(maxsize=None)
def _entry():
    fn = build.load("affine_relu_dot_moments").vince_affine_relu_dot_moments_bf16
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _shapes(y, a, b, w):
    """(M, C, F) of inputs the kernel takes; raises on any other."""
    dev = y.device
    check_tensor(y, "y", torch.bfloat16, 2, dev)
    check_tensor(a, "a", torch.float32, 1, dev)
    check_tensor(b, "b", torch.float32, 1, dev)
    m, c = y.shape
    if w.dim() != 2 or w.device != dev:
        raise ValueError(f"w must be a 2-D tensor on {dev}")
    f = w.shape[1]
    if a.shape[0] != c or b.shape[0] != c or w.shape[0] != c or not kernel_supported(m, c, f):
        raise ValueError(f"unsupported shapes y {tuple(y.shape)}, w {tuple(w.shape)}")
    return m, c, f


def _launch_with(y, a, b, w, p: Plan):
    """The kernel's three launches on the plan ``p``, uncounted (a measurement
    may try other plans through it)."""
    m, c, f = _shapes(y, a, b, w)
    dev = y.device
    # W^T in bf16 for the main kernel, so that TMA brings K-major boxes: one
    # copy, which casts too
    wt = torch.empty(f, c, device=dev, dtype=torch.bfloat16).copy_(w.t())
    out = torch.empty(m, f, device=dev, dtype=torch.bfloat16)
    s1 = torch.empty(c, device=dev, dtype=torch.float32)
    s2 = torch.empty(c, c, device=dev, dtype=torch.float32)
    s1_part = torch.empty(p.msplit, c, device=dev, dtype=torch.float32)
    s2_part = torch.empty(p.msplit, c, c, device=dev, dtype=torch.float32)
    status = _entry()(y.data_ptr(), a.data_ptr(), b.data_ptr(), wt.data_ptr(), out.data_ptr(),
                      s1.data_ptr(), s2.data_ptr(), s1_part.data_ptr(), s2_part.data_ptr(),
                      m, c, f, p.grid, p.fsplit, p.sc, p.msplit, p.rows,
                      torch.cuda.current_stream(dev).cuda_stream)
    build.check(status, "affine_relu_dot_moments")
    return out, s1, s2


def _launch(y, a, b, w):
    result = _launch_with(y, a, b, w, plan(*_shapes(y, a, b, w), sm_count(y.device)))
    affine_relu_dot_moments.launches += 1
    return result


def affine_relu_dot_moments_forward(y, a, b, w):
    """The forward: the kernel on a CUDA tensor, the plain version on the CPU."""
    a, b = a.float().contiguous(), b.float().contiguous()
    if use_kernel(y):
        return _launch(y.contiguous(), a, b, w)
    affine_relu_dot_moments.plain_calls += 1
    return _reference(y, a, b, w.to(y.dtype))


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
