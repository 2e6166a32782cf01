"""Stride-1 depthwise convolution for the EfficientNet MBConv blocks: the
port of the TPU kernel ``vince_tpu/ops/pallas/depthwise_kernel.py``
(``_dw_pallas`` / ``_dw_kernel``) and of its VJP.

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

What bounds the kernels on an H100 is the rate of instructions and their
latency, not bytes (an element is 4 bytes of traffic in bf16 and k² f32
operations). So a CTA stages each input row of its tile once through shared
memory with 16-byte asynchronous copies, a thread owns several neighbouring
columns of a channel pair and reuses every value it reads for all of them,
the weights are loaded once per CTA, and on the small maps a CTA walks several
images. ``_tiling`` chooses that tile from the shape; the source's header has
the design.

The forward kernel adds its taps in the plain version's order and rounds as
``_reference`` does (for bf16 one fused multiply-add per tap, which is the
same value because the f32 product of two bf16 values is exact; for f32 a
rounded product and a rounded sum), so on the card ``out`` and ``dx`` equal
``_reference`` bit for bit. The wgrad kernel rounds each product as its plain
version does (one packed bf16 multiply: again the exact product, rounded once)
and sums in f32 in another, fixed order, so dw is the same from run to run.

The JAX rule also turns away an image that does not fit the TPU's scoped VMEM
at 128-lane padding. That is no limit of a GPU: the CUDA kernel tiles rows,
columns and channels over CTAs and takes any N, H, W, C. The port therefore
runs EfficientNet-B0's first depthwise site (block_0: 112x112, C = 32)
through the kernel, where the JAX package sends it to XLA's grouped
convolution.
"""

import ctypes
import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

from vince_tpu_torch.ops.kernels import build, check_tensor, use_kernel

MAX_THREADS = 256
SMEM_LIMIT = 232448   # bytes of shared memory a CTA can use on sm_90
SMS = 132             # streaming multiprocessors of an H100
FIXED_ROWS = 3        # a CTA's start (weights, the ring's fill) and end, in rows of its walk
MIN_BAND_ROWS = 8     # a band re-reads k-1 input rows
STAGES = 4            # row buffers in the ring: 3 rows in flight (a constant of the source)
PARTIALS_SHARE = 0.1  # the filter gradient's partials against the bytes of x and g


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


class Tile(NamedTuple):
    """How one launch cuts x [N,H,W,C]: the arguments of the C entry points
    after the shape, then what follows from them."""
    cols: int        # neighbouring output columns a thread owns
    cpt: int         # channels a thread owns
    vec_bytes: int   # bytes of one staging copy
    chunk: int       # channels per CTA
    pitch: int       # elements between neighbouring staged pixels
    groups: int      # column groups (of ``cols`` columns) per image in a CTA
    slots: int       # images a CTA walks side by side
    images: int      # images a CTA walks in all, ``slots`` at a time
    band_rows: int   # output rows per CTA
    threads: int     # slots * groups * chunk / cpt
    ctas: int        # the grid: chunks * column tiles * bands * image groups
    parts: int       # partials of the filter gradient: the grid without the chunks
    smem_bytes: int

    @property
    def launch_args(self):
        return self[:9]


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def _bank_conflicts(pitch, cols, cpt, pairs, groups, twh, itemsize, threads) -> int:
    """The worst number of a warp's threads whose first tap falls into one of
    the 32 four-byte banks of shared memory (1: none collide)."""
    worst = 1
    for warp in range(0, threads, 32):
        banks = {}
        for t in range(warp, min(warp + 32, threads)):
            grp = t // pairs
            byte = (((grp // groups) * twh + (grp % groups) * cols) * pitch
                    + (t % pairs) * cpt) * itemsize
            banks[byte // 4 % 32] = banks.get(byte // 4 % 32, 0) + 1
        worst = max(worst, max(banks.values()))
    return worst


# Registers a thread of the bf16 kernels takes, by (filter gradient?, k,
# columns per thread), as ptxas reports them (``chip_smoke.py --ptxas``); the
# kernels are compiled for at most 128. Only to estimate how many CTAs an SM holds.
_REGISTERS = {(False, 3, 2): 72, (False, 3, 4): 96, (False, 3, 8): 128, (False, 5, 2): 104,
              (False, 5, 4): 120, (True, 3, 2): 72, (True, 3, 4): 88, (True, 3, 8): 112,
              (True, 5, 2): 112, (True, 5, 4): 128}


def _ctas_per_sm(threads: int, registers: int, smem_bytes: int) -> int:
    """How many CTAs of this size one SM holds: 65,536 registers (allocated
    by the warp), 64 warps, 32 CTAs, 227 KB of shared memory less 1 KB a CTA."""
    warps = _ceil_div(threads, 32)
    return max(1, min(65536 // (registers * 32 * warps), 64 // warps, 32,
                      SMEM_LIMIT // (smem_bytes + 1024)))


@functools.lru_cache(maxsize=None)
def _tiling(n: int, h: int, w: int, c: int, k: int, itemsize: int, wgrad: bool,
            cols=None, chunk=None, slots=None, images=None, band_rows=None,
            pitch=None) -> Tile:
    """The one place that maps a shape to the kernels' tile; pure Python. The
    keyword arguments fix a choice (the measurement tool sweeps them).

    A thread owns 2 channels where C is even, and 2, 4 or (k = 3) 8 neighbouring
    columns where the copies are 16 bytes (C·itemsize a multiple of 16), else 2
    columns and copies of its own channels. Every way to cut the shape (the
    chunk of channels, the columns per thread, images side by side where one
    image's columns do not fill the block, images per CTA, row bands) gets an
    estimate of the share of the card it keeps busy: the threads, columns and
    channel lanes that do work, the warps an SM holds, how evenly the grid
    fills whole waves of resident CTAs, the rows a CTA walks against its fixed
    cost, the halo rows and columns staged twice. The best estimate wins among
    the cuts with at least two CTAs per SM (or the largest grid, for a small
    shape); for the filter gradient only cuts whose partials (written and
    read again) stay under ``PARTIALS_SHARE`` of the bytes of x and g count."""
    cpt = 2 if c % 2 == 0 else 1
    vec_bytes = 16 if (c * itemsize) % 16 == 0 else cpt * itemsize
    vc = vec_bytes // itemsize
    max_parts = max(1, int(PARTIALS_SHARE * 2 * itemsize * n * h * w / (8 * k * k)))
    free_split = not (images or band_rows)

    def smem(slots_, groups, cols_, chunk_, pitch_, threads):
        twh = groups * cols_ + k - 1
        if wgrad:
            ring = STAGES * slots_ * (twh + groups * cols_) * pitch_ * itemsize
            return max(ring, 4 * k * k * cpt * threads)
        return (STAGES * slots_ * twh * pitch_ + k * k * chunk_) * itemsize

    best = None
    wide = ((8, 4, 2) if k == 3 else (4, 2)) if vec_bytes == 16 else (2,)
    for cols_ in ((cols,) if cols else wide):
        if cols_ not in wide:
            continue
        for chunk_ in ((chunk,) if chunk
                       else range(vc, min(128, _ceil_div(c, vc) * vc) + 1, vc)):
            pairs = chunk_ // cpt
            if pairs > MAX_THREADS:
                continue
            max_groups = MAX_THREADS // pairs
            ngroups = _ceil_div(w, cols_)
            coltiles = _ceil_div(ngroups, max_groups)
            groups = _ceil_div(ngroups, coltiles)
            slots_ = slots or (max(1, min(max_groups // groups, n, 8)) if coltiles == 1 else 1)
            threads = slots_ * groups * pairs
            if threads > MAX_THREADS:
                continue
            chunks = _ceil_div(c, chunk_)
            tw = groups * cols_
            if smem(slots_, groups, cols_, chunk_, chunk_ + 8 * vc, threads) > SMEM_LIMIT:
                continue
            per_sm = _ctas_per_sm(threads, _REGISTERS.get((wgrad, k, cols_), 128),
                                  smem(slots_, groups, cols_, chunk_, chunk_ + vc, threads))
            layout = (c / (chunks * chunk_)                      # channel lanes in use
                      * w / (coltiles * tw)                      # columns in use
                      * threads / (_ceil_div(threads, 32) * 32)  # lanes of the last warp
                      * n / (_ceil_div(n, slots_) * slots_)      # slots in use
                      * (1.0 if (chunk_ * itemsize) % 32 == 0 else 0.8)  # whole sectors
                      # a row's fixed cost over more outputs; 8 columns paid off only
                      # where the chunk is all of C, so that a staged row is one run
                      * {2: 0.8, 4: 1.0, 8: 1.2 if chunk_ >= c else 0.9}[cols_]
                      * (min(chunk_ * itemsize, 128) / 128) ** 0.25   # long runs of bytes
                      * (tw / (tw + k - 1)) ** 0.5               # halo columns staged
                      * min(1.0, per_sm * _ceil_div(threads, 32) / 16) ** 0.5)  # warps per SM
            seen = set()
            for batches in ([_ceil_div(images, slots_)] if images
                            else range(1, _ceil_div(n, slots_) + 1)):
                igroups = _ceil_div(n, batches * slots_)
                batches = _ceil_div(_ceil_div(n, igroups), slots_)  # no more than that needs
                for bands in ([_ceil_div(h, band_rows)] if band_rows
                              else range(1, max(1, h // MIN_BAND_ROWS) + 1)):
                    rows = _ceil_div(h, bands)
                    bands = _ceil_div(h, rows)  # the bands that equal rows leave
                    if (batches, bands) in seen:
                        continue
                    seen.add((batches, bands))
                    parts = coltiles * bands * igroups
                    ctas = chunks * parts
                    if wgrad and free_split and parts > max_parts:
                        continue
                    steps = batches * (rows + (k - 1 if bands > 1 else (k - 1) // 2))
                    estimate = (layout
                                * ctas / (_ceil_div(ctas, SMS * per_sm) * SMS * per_sm)  # waves
                                * steps / (steps + FIXED_ROWS)     # a CTA's fixed cost
                                * (rows / (rows + k - 1) if bands > 1 else 1.0) ** 0.75)  # halo
                    key = (min(ctas, 2 * SMS), estimate, chunk_)
                    if best is None or key > best[0]:
                        best = (key, cols_, chunk_, groups, slots_, batches, rows, threads,
                                ctas, parts)
    if best is None:
        raise ValueError(f"no tile for x [{n},{h},{w},{c}], k={k} with the choices given")
    _, cols, chunk, groups, slots, batches, rows, threads, ctas, parts = best
    if pitch is None:
        pitch = min(range(chunk, chunk + 8 * vc + 1, vc), key=lambda p: (
            _bank_conflicts(p, cols, cpt, chunk // cpt, groups, groups * cols + k - 1,
                            itemsize, threads), p))
    return Tile(cols, cpt, vec_bytes, chunk, pitch, groups, slots, batches * slots, rows,
                threads, ctas, parts, smem(slots, groups, cols, chunk, pitch, threads))


def _entry_points():
    """The library's two entry points, their argument types set once."""
    lib = build.load("depthwise_conv")
    if not getattr(lib, "_vince_typed", False):
        lib.vince_depthwise_conv.argtypes = (
            [ctypes.c_void_p] * 3 + [ctypes.c_int] * 15 + [ctypes.c_void_p])
        lib.vince_depthwise_wgrad.argtypes = (
            [ctypes.c_void_p] * 4 + [ctypes.c_int] * 15 + [ctypes.c_void_p])
        lib.vince_depthwise_conv.restype = lib.vince_depthwise_wgrad.restype = ctypes.c_int
        lib._vince_typed = True
    return lib.vince_depthwise_conv, lib.vince_depthwise_wgrad


def _checked(x, other, other_name, other_shape_ok, k):
    """The kernels take bf16 or f32, contiguous, on one card, at shapes that
    ``kernel_supported`` admits; anything else raises."""
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"x has dtype {x.dtype}, expected bfloat16 or float32")
    check_tensor(x, "x", x.dtype, 4, x.device)
    check_tensor(other, other_name, x.dtype, 4, x.device)
    n, _, _, c = x.shape
    if not other_shape_ok or not kernel_supported(x.shape, k, 1) or n == 0 or c == 0:
        raise ValueError(f"unsupported shapes x {tuple(x.shape)}, {other_name} "
                         f"{tuple(other.shape)}, k {k}")


def _aligned(t):
    """The staging copies need their 16 bytes aligned; a view at an odd offset is copied."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _launch(x, w):
    k = w.shape[0]
    _checked(x, w, "w", tuple(w.shape) == (k, k, 1, x.shape[3]), k)
    x, w = _aligned(x), _aligned(w)
    out = torch.empty_like(x)
    tile = _tiling(*x.shape, k, x.element_size(), False)
    status = _entry_points()[0](
        x.data_ptr(), w.data_ptr(), out.data_ptr(), *x.shape, k,
        int(x.dtype == torch.bfloat16), *tile.launch_args,
        torch.cuda.current_stream(x.device).cuda_stream)
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
    _checked(x, g, "g", g.shape == x.shape, k)
    x, g = _aligned(x), _aligned(g)
    c = x.shape[3]
    tile = _tiling(*x.shape, k, x.element_size(), True)
    part = torch.empty(tile.parts, k * k, c, device=x.device, dtype=torch.float32)
    dw = torch.empty(k, k, 1, c, device=x.device, dtype=torch.float32)
    status = _entry_points()[1](
        x.data_ptr(), g.data_ptr(), part.data_ptr(), dw.data_ptr(), *x.shape, k,
        int(x.dtype == torch.bfloat16), *tile.launch_args,
        torch.cuda.current_stream(x.device).cuda_stream)
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
