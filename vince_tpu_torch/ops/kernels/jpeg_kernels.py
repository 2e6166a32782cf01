"""The JPEG path's kernels (``csrc/jpeg_decode.cu``), each beside its plain
PyTorch version: ``ycc_resize_canvas``, the path's one kernel, from the YCbCr
planes nvJPEG decodes straight to the square uint8 canvas; and the two it
replaced, kept as stand-alone ops off every path: ``ycc_to_rgb`` (libjpeg's
chroma upsampling and YCbCr → RGB conversion) and ``resize_canvas`` (the
bilinear resize to the canvas), whose plain versions compose the fused
one's. The CPU's decode (``cv2``, then ``resize_canvas``'s plain version)
also runs here.

None replaces a TPU kernel: they are the counterparts of what the JAX
package runs on the host after libjpeg's decode, in libjpeg itself (the
upsampling and colour conversion of ``jdsample.c`` and ``jdcolor.c``, as
``cv2`` and ``vince_tpu/native/decode.cc`` both get them) and in
``decode.cc:54-114`` (``resize_bilinear_rgb``, ``cv2.INTER_LINEAR`` with
half-pixel centres). The images of a batch lie one after another in one
uint8 buffer; a ``meta`` tensor of int64 rows gives each one's place and
shape.
"""

import ctypes
import functools

import torch

from vince_tpu_torch.ops.kernels import build, check_tensor, use_kernel

# columns of ycc_to_rgb's meta: the planes' byte offset, height, width, chroma
# width, chroma height, horizontal and vertical subsampling (0, 0: grayscale),
# the RGB image's byte offset in the output
YCC_META = 8
# columns of ycc_resize_canvas's meta: YCC_META's first seven
FUSED_META = 7


def _replicate(plane: torch.Tensor, dim: int, step: int) -> torch.Tensor:
    """The plane shifted by one along ``dim`` (+1: the next row or column,
    -1: the previous), its edge replicated."""
    n = plane.shape[dim]
    index = (torch.arange(n, device=plane.device) + step).clamp(0, n - 1)
    return plane.index_select(dim, index)


def _interleave(even: torch.Tensor, odd: torch.Tensor, dim: int) -> torch.Tensor:
    return torch.stack([even, odd], dim=dim + 1).flatten(dim, dim + 1)


def upsample_plain(plane: torch.Tensor, hs: int, vs: int) -> torch.Tensor:
    """libjpeg's fancy upsampling (``jdsample.c``) of a chroma plane [ch, cw]
    by (hs, vs) in {1, 2}², int32, uncropped: h2v1 and h2v2 as triangular
    filters with libjpeg's biases (box replication for planes of width <= 2),
    h1v2 likewise in rows."""
    p = plane.to(torch.int32)
    if hs == 1 and vs == 1:
        return p
    if hs == 2 and p.shape[1] <= 2:  # h2v1_upsample, h2v2_upsample
        return p.repeat_interleave(vs, 0).repeat_interleave(2, 1)
    if vs == 1:  # h2v1_fancy_upsample
        even = (3 * p + _replicate(p, 1, -1) + 1) >> 2
        odd = (3 * p + _replicate(p, 1, 1) + 2) >> 2
        return _interleave(even, odd, 1)
    upper = 3 * p + _replicate(p, 0, -1)  # the column sums of each output row pair
    lower = 3 * p + _replicate(p, 0, 1)
    if hs == 1:  # h1v2_fancy_upsample
        return _interleave((upper + 1) >> 2, (lower + 2) >> 2, 0)
    rows = []
    for s in (upper, lower):  # h2v2_fancy_upsample
        even = (3 * s + _replicate(s, 1, -1) + 8) >> 4
        odd = (3 * s + _replicate(s, 1, 1) + 7) >> 4
        rows.append(_interleave(even, odd, 1))
    return _interleave(rows[0], rows[1], 0)


def ycc_to_rgb_image_plain(y: torch.Tensor, cb=None, cr=None, hs: int = 0,
                           vs: int = 0) -> torch.Tensor:
    """The plain version for one image: planes Y [h, w] and, unless
    grayscale, Cb and Cr [ch, cw] uint8 → RGB [h, w, 3] uint8, with libjpeg's
    fixed-point YCbCr → RGB (``jdcolor.c``, 16-bit fractions)."""
    h, w = y.shape
    luma = y.to(torch.int32)
    if hs == 0:
        return luma.to(torch.uint8)[..., None].expand(h, w, 3).contiguous()
    cb = upsample_plain(cb, hs, vs)[:h, :w] - 128
    cr = upsample_plain(cr, hs, vs)[:h, :w] - 128
    r = luma + ((91881 * cr + 32768) >> 16)
    g = luma + ((-22554 * cb + 32768 - 46802 * cr) >> 16)
    b = luma + ((116130 * cb + 32768) >> 16)
    return torch.stack([r, g, b], -1).clamp(0, 255).to(torch.uint8)


def _planes(src: torch.Tensor, offset: int, h: int, w: int, cw: int, ch: int, hs: int):
    """One frame's planes in ``src``: Y [h, w] and, unless grayscale, Cb and
    Cr [ch, cw]."""
    y = src[offset:offset + h * w].view(h, w)
    if not hs:
        return (y,)
    c0 = offset + h * w
    return y, src[c0:c0 + ch * cw].view(ch, cw), src[c0 + ch * cw:c0 + 2 * ch * cw].view(ch, cw)


def _reference_ycc_to_rgb(src, meta, total):
    out = torch.zeros(total, dtype=torch.uint8, device=src.device)
    for offset, h, w, cw, ch, hs, vs, rgb in meta.tolist():
        image = ycc_to_rgb_image_plain(*_planes(src, offset, h, w, cw, ch, hs), hs=hs, vs=vs)
        out[rgb:rgb + h * w * 3] = image.reshape(-1)
    return out


@functools.lru_cache(maxsize=None)
def _ycc_entry():
    fn = build.load("jpeg_decode").vince_ycc_to_rgb
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def ycc_to_rgb(src: torch.Tensor, meta: torch.Tensor, total: int, pixels: int) -> torch.Tensor:
    """A uint8 buffer of ``total`` bytes holding the RGB images of the planes
    packed in ``src`` (``meta`` [n, 8] int64, ``YCC_META``'s columns;
    ``pixels`` the largest image's h * w): the kernel on a CUDA tensor, the
    plain version on the CPU."""
    if not use_kernel(src):
        ycc_to_rgb.plain_calls += 1
        return _reference_ycc_to_rgb(src, meta, total)
    check_tensor(src, "src", torch.uint8, 1, src.device)
    check_tensor(meta, "meta", torch.int64, 2, src.device)
    n = meta.shape[0]
    if meta.shape[1] != YCC_META or not 0 < n <= 65535 or pixels <= 0:
        raise ValueError(f"unsupported meta {tuple(meta.shape)} or pixels {pixels}")
    out = torch.empty(total, dtype=torch.uint8, device=src.device)
    status = _ycc_entry()(src.data_ptr(), meta.data_ptr(), n, pixels, out.data_ptr(),
                          torch.cuda.current_stream(src.device).cuda_stream)
    build.check(status, "ycc_to_rgb")
    ycc_to_rgb.launches += 1
    return out


def _axis(n_in: int, n_out: int, device):
    """decode.cc's source coordinates along one axis, in float32: the lower
    neighbour, the upper (clamped to the edge) and the lerp weight."""
    scale = (torch.tensor(float(n_in), dtype=torch.float32)
             / torch.tensor(float(n_out), dtype=torch.float32)).to(device)
    f = ((torch.arange(n_out, dtype=torch.float32, device=device) + 0.5) * scale - 0.5).clamp_min(0)
    lo = f.to(torch.int64).clamp_max(n_in - 1)
    hi = (lo + 1).clamp_max(n_in - 1)
    return lo, hi, f - lo.to(torch.float32)


def resize_image_plain(image: torch.Tensor, canvas: int) -> torch.Tensor:
    """The plain PyTorch version for one image [h, w, 3] uint8 → [canvas,
    canvas, 3] uint8: decode.cc's arithmetic, each product and sum rounded on
    its own, in its order."""
    h, w = image.shape[:2]
    y0, y1, wy = _axis(h, canvas, image.device)
    x0, x1, wx = _axis(w, canvas, image.device)
    img = image.to(torch.int32)

    def horizontal(rows):  # [canvas, w, 3] → [canvas, canvas, 3] float32
        a, b = rows[:, x0], rows[:, x1]
        return a.to(torch.float32) + wx[None, :, None] * (b - a).to(torch.float32)

    t0, t1 = horizontal(img[y0]), horizontal(img[y1])
    return (t0 + wy[:, None, None] * (t1 - t0) + 0.5).to(torch.uint8)


def _reference_resize(src: torch.Tensor, meta: torch.Tensor, canvas: int) -> torch.Tensor:
    """The plain version of the batch: each image of ``src`` through
    ``resize_image_plain``."""
    out = []
    for offset, h, w in meta.tolist():
        image = src[offset:offset + h * w * 3].view(h, w, 3)
        out.append(resize_image_plain(image, canvas))
    return torch.stack(out)


@functools.lru_cache(maxsize=None)
def _resize_entry():
    fn = build.load("jpeg_decode").vince_resize_bilinear_rgb
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def resize_canvas(src: torch.Tensor, meta: torch.Tensor, canvas: int) -> torch.Tensor:
    """[n, canvas, canvas, 3] uint8 from the RGB images packed in ``src``
    (``meta`` [n, 3] int64: byte offset, height, width): the kernel on a CUDA
    tensor, the plain version on the CPU."""
    if not use_kernel(src):
        resize_canvas.plain_calls += 1
        return _reference_resize(src, meta, canvas)
    check_tensor(src, "src", torch.uint8, 1, src.device)
    check_tensor(meta, "meta", torch.int64, 2, src.device)
    n = meta.shape[0]
    if meta.shape[1] != 3 or not 0 < n <= 65535 or canvas <= 0:
        raise ValueError(f"unsupported meta {tuple(meta.shape)} or canvas {canvas}")
    out = torch.empty(n, canvas, canvas, 3, dtype=torch.uint8, device=src.device)
    status = _resize_entry()(src.data_ptr(), meta.data_ptr(), n, canvas, out.data_ptr(),
                             torch.cuda.current_stream(src.device).cuda_stream)
    build.check(status, "resize_bilinear_rgb")
    resize_canvas.launches += 1
    return out


def _reference_ycc_resize(src: torch.Tensor, meta: torch.Tensor, canvas: int) -> torch.Tensor:
    """The fused kernel's plain version: each frame through
    ``ycc_to_rgb_image_plain``, then ``resize_image_plain``."""
    out = []
    for offset, h, w, cw, ch, hs, vs in meta.tolist():
        rgb = ycc_to_rgb_image_plain(*_planes(src, offset, h, w, cw, ch, hs), hs=hs, vs=vs)
        out.append(resize_image_plain(rgb, canvas))
    return torch.stack(out)


@functools.lru_cache(maxsize=None)
def _fused_entry():
    fn = build.load("jpeg_decode").vince_ycc_resize_canvas
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def ycc_resize_canvas(src: torch.Tensor, meta: torch.Tensor, canvas: int) -> torch.Tensor:
    """[n, canvas, canvas, 3] uint8 from the YCbCr planes packed in ``src``
    (``meta`` [n, 7] int64, ``FUSED_META``'s columns): the fused kernel on a
    CUDA tensor, the plain version (``resize_canvas(ycc_to_rgb(...))`` frame
    by frame) on the CPU."""
    if meta.dim() != 2 or meta.shape[1] != FUSED_META or not 0 < meta.shape[0] <= 65535 \
            or canvas <= 0:
        raise ValueError(f"unsupported meta {tuple(meta.shape)} or canvas {canvas}")
    if not use_kernel(src):
        ycc_resize_canvas.plain_calls += 1
        return _reference_ycc_resize(src, meta, canvas)
    check_tensor(src, "src", torch.uint8, 1, src.device)
    check_tensor(meta, "meta", torch.int64, 2, src.device)
    n = meta.shape[0]
    out = torch.empty(n, canvas, canvas, 3, dtype=torch.uint8, device=src.device)
    status = _fused_entry()(src.data_ptr(), meta.data_ptr(), n, canvas, out.data_ptr(),
                            torch.cuda.current_stream(src.device).cuda_stream)
    build.check(status, "ycc_resize_canvas")
    ycc_resize_canvas.launches += 1
    return out


for _wrapper in (ycc_resize_canvas, ycc_to_rgb, resize_canvas):
    _wrapper.launches = 0
    _wrapper.plain_calls = 0
