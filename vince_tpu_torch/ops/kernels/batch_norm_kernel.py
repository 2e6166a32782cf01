"""flax's BatchNorm over the last dimension, with the residual add and the
ReLU fused in (no TPU kernel: XLA fuses the JAX package's ``nn.BatchNorm``).

    batch_norm(x [..., C], weight [C], bias [C], eps, running=None, group=None,
               relu=False, residual=None, dtype=None) -> (out, mean, var)

In train mode (``running`` None) the statistics are the batch's in float32,
mean = E[x] and var = max(E[x²] − mean², 0), their moments summed over
``group`` where one is given (``--sync-bn``); in eval mode they are
``running`` = (mean, var). Then out = round((x − mean)·(rsqrt(var + ε)·w) + b)
in x's type, + ``residual``, relu, in that order and rounding, cast to
``dtype`` (x's by default; only without a residual).

On a CUDA tensor this is ``csrc/batch_norm.cu``: forward, the statistics
(per-slab partial sums, then their sum in a fixed order) and one apply pass;
backward, one pass for the gradient sums and one for dx, with the ReLU's mask
from the saved output. ``layout`` is the kernels' grid, and ``elements``
models in Python the elements it gives each thread. On the CPU it is the
plain version, the port's composed PyTorch arithmetic, differentiated by
autograd.
"""

import ctypes
import functools
import math
from typing import NamedTuple, Optional, Tuple

import torch

from vince_tpu_torch.ops.kernels import H100_SMS, build, check_tensor, sm_count, use_kernel
from vince_tpu_torch.parallel.collectives import group_size, psum

_THREADS = 256
_MAX_TILE = 32  # channel vectors a CTA covers: 256 bf16 channels, 128 f32
_MAX_CTAS_PER_SM = 8  # 2048 threads
_STATS, _APPLY, _GRAD_STATS, _GRAD_APPLY = range(4)  # the kernels, as the C entries name them
_DTYPES = (torch.bfloat16, torch.float32)


def _plain(x, weight, bias, eps, running, group, relu, residual, dtype):
    """The plain PyTorch version (the port's BatchNorm arithmetic as it was
    composed before the kernels)."""
    if running is None:
        x32 = x.float()
        dims = tuple(range(x.dim() - 1))
        # one [2, C] tensor of the moments whether or not they are summed
        # over the group: the backward then runs its sums in one order, and
        # a world of one gives the single device's bits
        moments = torch.stack([x32.mean(dim=dims), (x32 * x32).mean(dim=dims)])
        if group is not None:
            moments = psum(moments, group) / group_size(group)
        mean, mean2 = moments.unbind()
        var = torch.clamp(mean2 - mean * mean, min=0.0)
    else:
        mean, var = running
    mul = torch.rsqrt(var + eps) * weight
    y = ((x.float() - mean) * mul + bias).to(x.dtype)
    if residual is not None:
        y = y + residual
    if relu:
        y = torch.relu(y)
    return y.to(dtype), mean, var


class Layout(NamedTuple):
    vec: int  # channels a thread reads at once: 8 bf16 or 4 f32 (16 bytes), or 1
    tile: int  # channel vectors of a CTA
    ctiles: int  # CTAs across the channels
    slabs: int  # CTAs along the rows, each summing its slab
    slab_rows: int


def layout(m: int, c: int, vec: int, sms: int = H100_SMS, ctas_per_sm: int = 4) -> Layout:
    """One wave of ``ctas_per_sm`` CTAs of 256 threads an SM: a CTA covers
    ``tile`` channel vectors and 256 // tile rows at a time over its slab of
    rows."""
    nvec = c // vec
    tile = min(nvec, _MAX_TILE)
    ctiles = math.ceil(nvec / tile)
    rows = _THREADS // tile
    slabs = max(1, min(math.ceil(m / rows), math.ceil(ctas_per_sm * sms / ctiles)))
    slab_rows = math.ceil(math.ceil(m / slabs) / rows) * rows
    return Layout(vec, tile, ctiles, math.ceil(m / slab_rows), slab_rows)


def elements(m: int, c: int, lay: Layout):
    """(row, first channel) of each vector a thread of the layout reads, in
    the kernels' order: slab, channel tile, thread, row."""
    rows = _THREADS // lay.tile
    for slab in range(lay.slabs):
        r0, r1 = slab * lay.slab_rows, min(m, (slab + 1) * lay.slab_rows)
        for ct in range(lay.ctiles):
            for t in range(rows * lay.tile):
                lr, lc = divmod(t, lay.tile)
                cv = ct * lay.tile + lc
                if cv < c // lay.vec:
                    for r in range(r0 + lr, r1, rows):
                        yield r, cv * lay.vec


def _vec(c: int, *tensors) -> int:
    """The widest vector that C and every tensor's address allow: 8 channels
    (16 bytes of bf16), 4 (16 bytes of f32, 8 of bf16), or 1."""
    widths = (8, 4) if all(t.dtype == torch.bfloat16 for t in tensors) else (4,)
    for width in widths:
        if c % width == 0 and all(t.data_ptr() % (width * t.element_size()) == 0
                                  for t in tensors):
            return width
    return 1


@functools.lru_cache(maxsize=None)
def _entries():
    lib = build.load("batch_norm")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    spec = {  # the argument types of each C entry, the stream last
        "vince_bn_stats": [p, p, i, i, i, i, i, i, i, p],
        "vince_bn_finish": [p, i, i, f, p, p, p, p, p],
        "vince_bn_apply": [p] * 7 + [f] + [i] * 9 + [p],
        "vince_bn_grad_stats": [p] * 6 + [i] * 8 + [p],
        "vince_bn_grad_finish": [p, i, i, p, p, p, f, f, p, p, p, p, p],
        "vince_bn_grad_apply": [p] * 6 + [i] * 8 + [p],
        "vince_bn_ctas_per_sm": [i] * 4,
    }
    fns = {}
    for name, argtypes in spec.items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
        fns[name] = fn
    return fns


@functools.lru_cache(maxsize=None)
def _ctas_per_sm(kind: int, in_bf16: int, out_bf16: int, vec: int) -> int:
    n = _entries()["vince_bn_ctas_per_sm"](kind, in_bf16, out_bf16, vec)
    if n <= 0:
        raise RuntimeError(f"batch_norm: no occupancy for kernel {kind} (CUDA error {-n})")
    return min(n, _MAX_CTAS_PER_SM)


def _layout(kind: int, x: torch.Tensor, out: torch.Tensor, vec: int) -> Layout:
    """The layout of kernel ``kind`` over x [M, C] (out: the output's type)."""
    m, c = x.shape
    ctas = _ctas_per_sm(kind, _is_bf16(x), _is_bf16(out), vec)
    return layout(m, c, vec, sm_count(x.device), ctas)


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _is_bf16(t: torch.Tensor) -> int:
    return int(t.dtype == torch.bfloat16)


def _call(dev: torch.device, name: str, *args):
    """One launch through the C entry ``name`` on ``dev``'s current stream."""
    fn = _entries()[name]
    stream = torch.cuda.current_stream(dev).cuda_stream
    build.check(fn(*args, stream), f"batch_norm ({name})")
    batch_norm.launches += 1


def _grid_args(lay: Layout):
    return (lay.vec, lay.tile, lay.slabs, lay.slab_rows)


def _stats(x, vec: int, group):
    """(mean, var, t) [C] of x [M, C]: t = E[x²] − mean² before the clamp."""
    m, c = x.shape
    dev = x.device
    lay = _layout(_STATS, x, x, vec)
    f32 = dict(device=dev, dtype=torch.float32)
    parts = torch.empty(lay.slabs, 2, c, **f32)
    _call(dev, "vince_bn_stats", x.data_ptr(), parts.data_ptr(), m, c, _is_bf16(x),
          *_grid_args(lay))
    mean, var, t = (torch.empty(c, **f32) for _ in range(3))
    if group is None:
        _call(dev, "vince_bn_finish", parts.data_ptr(), lay.slabs, c, float(m), mean.data_ptr(),
              var.data_ptr(), t.data_ptr(), None)
        return mean, var, t
    moments = torch.empty(2, c, **f32)
    _call(dev, "vince_bn_finish", parts.data_ptr(), lay.slabs, c, float(m), None, None, None,
          moments.data_ptr())
    moments = psum(moments, group) / group_size(group)
    _call(dev, "vince_bn_finish", moments.data_ptr(), 1, c, 1.0, mean.data_ptr(), var.data_ptr(),
          t.data_ptr(), None)
    return mean, var, t


def _check(x, weight, bias, residual, running, dtype):
    """Raises on inputs the kernels do not take."""
    dev = x.device
    if x.dim() != 2 or x.dtype not in _DTYPES or dtype not in _DTYPES:
        raise ValueError(f"x must be a 2-D bf16 or f32 tensor and dtype one of them, not "
                         f"{x.dtype} {tuple(x.shape)} -> {dtype}")
    check_tensor(x, "x", x.dtype, 2, dev)
    c = x.shape[1]
    for name, t in (("weight", weight), ("bias", bias), *zip(("mean", "var"), running or ())):
        check_tensor(t, name, torch.float32, 1, dev)
        if t.shape[0] != c:
            raise ValueError(f"{name} has {t.shape[0]} channels, x {c}")
    if residual is not None:
        check_tensor(residual, "residual", dtype, 2, dev)
        if residual.shape != x.shape or dtype != x.dtype:
            raise ValueError("the residual must have x's shape and type")
    if x.shape[0] == 0:
        raise ValueError("x has no rows")


class _BatchNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, bias, residual, running_mean, running_var, eps, group, relu,
                dtype):
        running = None if running_mean is None else (running_mean, running_var)
        _check(x, weight, bias, residual, running, dtype)
        m, c = x.shape
        dev = x.device
        y = torch.empty(m, c, device=dev, dtype=dtype)
        vec = _vec(c, *(t for t in (x, y, residual) if t is not None))
        if running is None:
            mean, var, t = _stats(x, vec, group)
        else:
            (mean, var), t = running, None
        lay = _layout(_APPLY, x, y, vec)
        _call(dev, "vince_bn_apply", x.data_ptr(), _ptr(residual), y.data_ptr(), mean.data_ptr(),
              var.data_ptr(), weight.data_ptr(), bias.data_ptr(), eps, int(relu), m, c,
              _is_bf16(x), _is_bf16(y), *_grid_args(lay))
        ctx.save_for_backward(x, weight, mean, var, t, y if relu else None)
        ctx.eps, ctx.group, ctx.relu, ctx.residual = eps, group, relu, residual is not None
        ctx.set_materialize_grads(False)
        if running is not None:
            return y
        ctx.mark_non_differentiable(mean, var)
        return y, mean, var

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, gy, *_):
        x, weight, mean, var, t, z = ctx.saved_tensors
        need_x, need_w, need_b, need_r = ctx.needs_input_grad[:4]
        if gy is None:
            return (None,) * 10
        gy = gy.contiguous()
        m, c = x.shape
        dev = x.device
        f32 = dict(device=dev, dtype=torch.float32)
        # the masked gradient as a tensor only where the fused residual takes it
        gres = torch.empty_like(gy) if ctx.residual and ctx.relu and need_r else None
        dx = torch.empty_like(x) if need_x else None
        vec = _vec(c, *(u for u in (gy, x, z, gres, dx) if u is not None))
        lay = _layout(_GRAD_STATS, x, gy, vec)
        parts = torch.empty(lay.slabs, 2, c, **f32)
        _call(dev, "vince_bn_grad_stats", gy.data_ptr(), x.data_ptr(), _ptr(z), mean.data_ptr(),
              parts.data_ptr(), _ptr(gres), m, c, _is_bf16(x), _is_bf16(gy),
              *_grid_args(lay))
        dw = torch.empty(c, **f32) if need_w else None
        db = torch.empty(c, **f32) if need_b else None
        coef = torch.empty(3, c, **f32) if need_x else None
        common = (var.data_ptr(), _ptr(t), weight.data_ptr(), ctx.eps)
        group = ctx.group if t is not None else None
        if group is None:
            _call(dev, "vince_bn_grad_finish", parts.data_ptr(), lay.slabs, c, *common, float(m),
                  None, _ptr(dw), _ptr(db), _ptr(coef))
        else:
            sums = torch.empty(2, c, **f32)
            _call(dev, "vince_bn_grad_finish", parts.data_ptr(), lay.slabs, c, *common, float(m),
                  sums.data_ptr(), _ptr(dw), _ptr(db), None)
            if need_x:
                sums = psum(sums, group)
                _call(dev, "vince_bn_grad_finish", sums.data_ptr(), 1, c, *common,
                      float(m * group_size(group)), None, None, None, coef.data_ptr())
        if need_x:
            src, mask = (gres, None) if gres is not None else (gy, z)
            _call(dev, "vince_bn_grad_apply", src.data_ptr(), _ptr(mask), x.data_ptr(),
                  mean.data_ptr(), coef.data_ptr(), dx.data_ptr(), m, c, _is_bf16(x),
                  _is_bf16(gy), *_grid_args(_layout(_GRAD_APPLY, x, gy, vec)))
        dres = None
        if ctx.residual and need_r:
            dres = gres if ctx.relu else gy
        return dx, dw, db, dres, None, None, None, None, None, None


def batch_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, eps: float, *,
               running: Optional[Tuple[torch.Tensor, torch.Tensor]] = None, group=None,
               relu: bool = False, residual: Optional[torch.Tensor] = None,
               dtype: Optional[torch.dtype] = None):
    """(out, mean, var): the kernels on a CUDA tensor, the plain version on the
    CPU. ``mean`` and ``var`` are the statistics used (``running`` in eval
    mode), for the running averages; ``group`` is ignored in eval mode."""
    dtype = dtype or x.dtype
    if residual is not None and dtype != x.dtype:
        raise ValueError("an output dtype other than x's is taken only without a residual")
    if not use_kernel(x):
        batch_norm.plain_calls += 1
        return _plain(x, weight, bias, eps, running, None if running else group, relu,
                      residual, dtype)
    c = x.shape[-1]
    rm, rv = running or (None, None)
    res = None if residual is None else residual.reshape(-1, c).contiguous()
    out = _BatchNorm.apply(x.reshape(-1, c).contiguous(), weight, bias, res, rm, rv, eps,
                           None if running else group, relu, dtype)
    if running is not None:
        return out.view(x.shape), rm, rv
    y, mean, var = out
    return y.view(x.shape), mean, var


batch_norm.launches = 0
batch_norm.plain_calls = 0
