"""The JPEG path's fused kernel, ``ycc_resize_canvas``
(``ops/kernels/jpeg_kernels.py``; ``csrc/jpeg_decode.cu`` on the card), on
the CPU, where its wrapper runs the plain version.

- The plain version on packed ragged batches (4:2:0, 4:2:2, 4:4:0, 4:4:4 at
  even and odd sizes, chroma planes of width <= 2, grayscale, and all of
  them in one batch; the canvas below and above the sources' size) bit-equal
  to the two kernels it replaced composed, ``resize_canvas(ycc_to_rgb(...))``.
- Against the JAX package's host decoder (``vince_tpu.native.decode_jpeg``:
  libjpeg's decode, then ``decode.cc``'s resize) on JPEGs whose YCbCr planes
  are known exactly (colours constant over each MCU, at quality 100, as
  ``tests/test_torch_port_native_decode.py`` makes them), at sizes where
  ``decode.cc`` picks no DCT scale: ``tests/test_native_decode.py``'s
  full-scale tolerances, mean absolute difference < 1 and 99th percentile
  <= 4; whether the two are bit-equal is recorded
  (``record_property("bit_equal", ...)``) and printed.
- The kernel's own source (``csrc/jpeg_decode.cu``) on the host, through
  ``tests/torch_port_jpeg_standin.py`` (``g++``, one thread per CUDA
  thread): bit-equal to the plain version on ragged batches, with bands of
  1, 2 and 8 rows and the rows the launch picks; and the native module's
  card path on that stand-in: one meta copy (non-blocking, pinned), one
  launch and one synchronise per decode call.
- The wrapper: on a CPU tensor a plain call counted and no launch; a
  malformed meta or canvas refused.
"""

import cv2
import numpy as np
import pytest
import torch

from vince_tpu import native as jnative
from vince_tpu_torch.ops.kernels.jpeg_kernels import (
    FUSED_META, resize_canvas, ycc_resize_canvas, ycc_to_rgb)
import torch_port_jpeg_standin as standin
from torch_port_threads import one_intra_op_thread  # noqa: F401  (a module fixture)

ALIGN = 256  # the decode's alignment of each frame's planes and RGB image


def _aligned(n):
    return -(-n // ALIGN) * ALIGN


def _pack(frames):
    """frames: (Y [h, w], Cb, Cr [ch, cw] or None, hs, vs) uint8 → the
    packed planes, the fused meta [n, 7], and the old pair's metas
    (``ycc_to_rgb``'s [n, 8], its buffer's bytes and largest image's
    pixels, ``resize_canvas``'s [n, 3])."""
    chunks, meta, at, rgb_at = [], [], 0, 0
    pair = []
    for y, cb, cr, hs, vs in frames:
        flat = np.concatenate([p.ravel() for p in (y, cb, cr) if p is not None])
        ch, cw = cb.shape if cb is not None else (0, 0)
        meta.append([at, *y.shape, cw, ch, hs, vs])
        pair.append([at, *y.shape, cw, ch, hs, vs, rgb_at])
        chunks += [flat, np.zeros(_aligned(flat.size) - flat.size, np.uint8)]
        at += _aligned(flat.size)
        rgb_at += _aligned(3 * y.size)
    src = torch.from_numpy(np.concatenate(chunks))
    pair = torch.tensor(pair)
    pixels = max(y.size for y, *_ in frames)
    return src, torch.tensor(meta), (pair, rgb_at, pixels, pair[:, [7, 1, 2]].contiguous())


def _random_frame(rng, h, w, hs, vs):
    y = rng.randint(0, 256, (h, w), np.uint8)
    if not hs:
        return y, None, None, 0, 0
    ch, cw = -(-h // vs), -(-w // hs)
    return (y, rng.randint(0, 256, (ch, cw), np.uint8), rng.randint(0, 256, (ch, cw), np.uint8),
            hs, vs)


# (name, [(h, w, hs, vs), ...]): each layout at an even and an odd size
LAYOUTS = [
    ("420", [(36, 48, 2, 2), (37, 51, 2, 2)]),
    ("422", [(30, 40, 2, 1), (29, 41, 2, 1)]),
    ("440", [(32, 24, 1, 2), (33, 25, 1, 2)]),
    ("444", [(20, 28, 1, 1), (21, 27, 1, 1)]),
    ("chroma_width_le_2", [(6, 3, 2, 2), (5, 4, 2, 1), (1, 1, 2, 2), (3, 2, 1, 2), (2, 1, 1, 1)]),
    ("grayscale", [(24, 32, 0, 0), (17, 9, 0, 0)]),
    ("mixed", [(36, 48, 2, 2), (29, 41, 2, 1), (33, 25, 1, 2), (21, 27, 1, 1), (6, 3, 2, 2),
               (17, 9, 0, 0), (60, 7, 2, 2), (5, 70, 2, 2)]),
]


@pytest.mark.parametrize("canvas", [16, 77], ids=["down", "up"])
@pytest.mark.parametrize("name,shapes", LAYOUTS, ids=[name for name, _ in LAYOUTS])
def test_plain_version_equals_the_old_pair(name, shapes, canvas):
    rng = np.random.RandomState(len(name) + canvas)
    src, meta, (ycc_meta, total, pixels, resize_meta) = _pack(
        [_random_frame(rng, *shape) for shape in shapes])
    got = ycc_resize_canvas(src, meta, canvas)
    want = resize_canvas(ycc_to_rgb(src, ycc_meta, total, pixels), resize_meta, canvas)
    assert got.shape == (len(shapes), canvas, canvas, 3) and got.dtype == torch.uint8
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def _fix(x):
    return int(x * 65536 + 0.5)


def _libjpeg_rgb_to_ycc(rgb):
    """libjpeg's encoder conversion (``jccolor.c``): Y, Cb, Cr int64."""
    r, g, b = (rgb[..., i].astype(np.int64) for i in range(3))
    bias = (128 << 16) + 32768 - 1
    return ((_fix(0.299) * r + _fix(0.587) * g + _fix(0.114) * b + 32768) >> 16,
            (-_fix(0.16874) * r - _fix(0.33126) * g + _fix(0.5) * b + bias) >> 16,
            (_fix(0.5) * r - _fix(0.41869) * g - _fix(0.08131) * b + bias) >> 16)


def _mcu_constant_jpeg(h, w, factor, hs, vs, seed):
    """A quality-100 JPEG whose colour is constant over each MCU, and its
    exact planes (Y, Cb, Cr): every block holds its DC alone."""
    bh, bw = 8 * vs, 8 * hs
    blocks = np.random.RandomState(seed).randint(
        0, 256, (-(-h // bh), -(-w // bw), 3)).astype(np.uint8)
    img = np.repeat(np.repeat(blocks, bh, 0), bw, 1)[:h, :w]
    ok, enc = cv2.imencode(".jpg", np.ascontiguousarray(img[:, :, ::-1]),
                           [cv2.IMWRITE_JPEG_QUALITY, 100,
                            cv2.IMWRITE_JPEG_SAMPLING_FACTOR, factor])
    assert ok
    y, cb, cr = _libjpeg_rgb_to_ycc(blocks)
    ch, cw = -(-h // vs), -(-w // hs)
    planes = [np.repeat(np.repeat(y, bh, 0), bw, 1)[:h, :w]] + [
        np.repeat(np.repeat(c, 8, 0), 8, 1)[:ch, :cw] for c in (cb, cr)]
    return enc.tobytes(), [p.astype(np.uint8) for p in planes]


def _jax_scales(h, w, canvas):
    """decode.cc's DCT scale: the least m/8 whose output covers the canvas."""
    return next((m for m in range(1, 9) if (h * m + 7) // 8 >= canvas
                 and (w * m + 7) // 8 >= canvas), 8) < 8


@pytest.mark.parametrize("shape,canvas", [((96, 128), 112), ((37, 53), 64)],
                         ids=["96x128_to_112", "37x53_to_64"])
@pytest.mark.parametrize("factor,hs,vs", [(0x221111, 2, 2), (0x211111, 2, 1),
                                          (0x121111, 1, 2), (0x111111, 1, 1)],
                         ids=["420", "422", "440", "444"])
def test_against_the_jax_native_decoder(factor, hs, vs, shape, canvas, record_property):
    if not jnative.available():
        pytest.skip("the JAX package's native decoder does not build here (no g++ or libjpeg)")
    h, w = shape
    assert not _jax_scales(h, w, canvas)  # decode.cc decodes at full size
    data, (y, cb, cr) = _mcu_constant_jpeg(h, w, factor, hs, vs, seed=h + factor % 11)
    src, meta, _ = _pack([(y, cb, cr, hs, vs)])
    got = ycc_resize_canvas(src, meta, canvas)[0].numpy()
    ref = jnative.decode_jpeg(data, canvas)
    assert got.shape == ref.shape == (canvas, canvas, 3)
    d = np.abs(got.astype(np.int16) - ref.astype(np.int16))
    bit_equal = not d.any()
    record_property("bit_equal", bit_equal)
    print(f"{shape} h{hs}v{vs} to {canvas}: mean {d.mean():.4f}, p99 "
          f"{np.percentile(d, 99)}, max {d.max()}, bit-equal {bit_equal}")
    assert d.mean() < 1.0 and np.percentile(d, 99) <= 4


def test_wrapper_counts_a_plain_call_on_the_cpu():
    src, meta, _ = _pack([_random_frame(np.random.RandomState(0), 12, 16, 2, 2)])
    launches, plain = ycc_resize_canvas.launches, ycc_resize_canvas.plain_calls
    out = ycc_resize_canvas(src, meta, 8)
    assert out.shape == (1, 8, 8, 3)
    assert ycc_resize_canvas.launches == launches
    assert ycc_resize_canvas.plain_calls == plain + 1
    assert meta.shape[1] == FUSED_META


@pytest.mark.parametrize("bad", ["eight_columns", "one_dim", "no_frames", "canvas_0"])
def test_wrapper_refuses_a_malformed_meta(bad):
    src, meta, (ycc_meta, *_) = _pack([_random_frame(np.random.RandomState(1), 12, 16, 2, 2)])
    canvas = 8
    if bad == "eight_columns":
        meta = ycc_meta
    elif bad == "one_dim":
        meta = meta[0]
    elif bad == "no_frames":
        meta = meta[:0]
    else:
        canvas = 0
    plain = ycc_resize_canvas.plain_calls
    with pytest.raises(ValueError, match="unsupported meta"):
        ycc_resize_canvas(src, meta, canvas)
    assert ycc_resize_canvas.plain_calls == plain


@pytest.fixture(scope="module")
def host_kernels():
    lib = standin.build()
    if lib is None:
        pytest.skip("the stand-in of jpeg_decode.cu does not build here (no g++ or libjpeg)")
    return lib


# (layout, canvas, the band's rows: 0 for the launch's choice)
SOURCE_CASES = [("mixed", 16, 0), ("mixed", 77, 8), ("420", 37, 2), ("422", 37, 1),
                ("chroma_width_le_2", 9, 8), ("grayscale", 40, 0), ("440", 23, 4),
                ("wide_and_tall", 30, 4)]
SHAPES = dict(LAYOUTS, wide_and_tall=[(400, 20, 2, 2), (10, 700, 2, 2), (9, 333, 1, 1)])


@pytest.mark.parametrize("name,canvas,rows", SOURCE_CASES,
                         ids=[f"{n}-{c}-rows{r}" for n, c, r in SOURCE_CASES])
def test_the_kernel_source_on_the_host(host_kernels, name, canvas, rows):
    rng = np.random.RandomState(canvas + rows)
    src, meta, _ = _pack([_random_frame(rng, *shape) for shape in SHAPES[name]])
    got = standin.fused(host_kernels, src, meta, canvas, rows)
    torch.testing.assert_close(got, ycc_resize_canvas(src, meta, canvas), rtol=0, atol=0)


def test_the_card_path_on_the_host(host_kernels):
    standin.rehearse()
