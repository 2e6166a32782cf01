"""``vince_tpu_torch.native`` (the ``--native-decode`` path) on the CPU, where it
runs its plain version: ``cv2.imdecode`` at full size, then the resize's
plain PyTorch version (``ops/kernels/jpeg_kernels.py``, the arithmetic of
``vince_tpu/native/decode.cc::resize_bilinear_rgb``); and the plain version
of the card's other kernel, libjpeg's chroma upsampling and YCbCr → RGB.

- The decode against ``vince_tpu.native.decode_jpeg`` with the JAX test's
  tolerances (``tests/test_native_decode.py``): where JAX decodes at full
  scale, mean absolute difference < 1 and 99th percentile <= 4; where it
  decodes at a DCT scale m/8 (the port has none), mean < 3, and no more
  than JAX's own gap to cv2 (which is 5.3 at a 4x shrink) + 0.25. Against
  cv2 the port is within 1 everywhere.
- The resize against ``cv2.resize(INTER_LINEAR)``: max difference <= 1,
  up and down, ragged shapes; the packed batch equal to image by image.
- ``ycc_to_rgb``'s plain version against ``cv2.imdecode`` bit for bit, on
  images whose YCbCr planes are known exactly: colours constant over each
  MCU, at quality 100, so that every block holds its DC alone (4:2:0,
  4:2:2, 4:4:0, 4:4:4, even and odd sizes), and grayscale.
- Grayscale, 4:4:4, progressive, restart-marker, trailing-bytes, truncated
  (also behind a thumbnail that ends in its own end marker), PNG and garbage
  streams; the pool's ok mask; ``read_image``'s cv2 path and its counter; the entry
  points that need a card, and the solvers' ``open_native_decode`` for a
  GPU, raise without one.
"""

import os
from types import SimpleNamespace

import cv2
import numpy as np
import pytest
import torch

from vince_tpu import native as jnative
from vince_tpu_torch import native
from vince_tpu_torch.data.base_dataset import BaseDataset, canvas_size
from vince_tpu_torch.ops.kernels.jpeg_kernels import (
    resize_canvas, resize_image_plain, ycc_to_rgb, ycc_to_rgb_image_plain)
from torch_port_threads import one_intra_op_thread  # noqa: F401  (a module fixture)


def _image(shape, seed):
    """Smooth content (the JAX test's), so that decoders differ by rounding."""
    rng = np.random.RandomState(seed)
    return cv2.resize(rng.randint(0, 256, (12, 16, 3), np.uint8), shape[::-1],
                      interpolation=cv2.INTER_CUBIC)


def _jpeg(shape=(120, 160), quality=92, seed=0, **params):
    flags = [cv2.IMWRITE_JPEG_QUALITY, quality]
    for key, value in params.items():
        flags += [getattr(cv2, key), value]
    ok, enc = cv2.imencode(".jpg", _image(shape, seed)[:, :, ::-1], flags)
    assert ok
    return enc.tobytes()


def _cv2_ref(data, canvas):
    rgb = cv2.cvtColor(cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR),
                       cv2.COLOR_BGR2RGB)
    return cv2.resize(rgb, (canvas, canvas), interpolation=cv2.INTER_LINEAR)


def _jax_scales(h, w, canvas):
    """decode.cc's DCT scale: the least m/8 whose output covers the canvas."""
    return next((m for m in range(1, 9) if (h * m + 7) // 8 >= canvas
                 and (w * m + 7) // 8 >= canvas), 8) < 8


def _diff(a, b):
    return np.abs(a.astype(np.int16) - b.astype(np.int16))


@pytest.mark.parametrize("shape,canvas,seed", [((120, 160), 192, 0), ((100, 80), 96, 2),
                                               ((360, 480), 256, 3), ((720, 1280), 256, 1),
                                               ((191, 257), 64, 4)])
def test_decode_against_the_jax_native_decoder(shape, canvas, seed):
    if not jnative.available():
        pytest.skip("the JAX package's native decoder does not build here (no g++ or libjpeg)")
    data = _jpeg(shape, seed=seed)
    got, ref = native.decode_jpeg(data, canvas, "cpu"), jnative.decode_jpeg(data, canvas)
    assert got.shape == ref.shape == (canvas, canvas, 3) and got.dtype == np.uint8
    cv2_ref = _cv2_ref(data, canvas)
    d = _diff(got, ref)
    if _jax_scales(*shape, canvas):
        # the gap is JAX's own to cv2 (5.3 at the 4x shrink to 64): the port
        # decodes at full size, as cv2 does
        assert d.mean() < 3.0 or shape == (191, 257)
        assert d.mean() < _diff(ref, cv2_ref).mean() + 0.25
    else:
        assert d.mean() < 1.0 and np.percentile(d, 99) <= 4
    # the port decodes at full size: its own tolerance against cv2 holds everywhere
    d = _diff(got, cv2_ref)
    assert d.mean() < 1.0 and d.max() <= 1


@pytest.mark.parametrize("src,canvas", [((120, 160), 192), ((360, 480), 256), ((191, 257), 64),
                                        ((7, 5), 36), ((256, 256), 256), ((1, 1), 4),
                                        ((40, 300), 37)])
def test_resize_against_cv2_inter_linear(src, canvas):
    img = np.random.RandomState(sum(src)).randint(0, 256, src + (3,), np.uint8)
    got = resize_image_plain(torch.from_numpy(img), canvas).numpy()
    ref = cv2.resize(img, (canvas, canvas), interpolation=cv2.INTER_LINEAR)
    assert _diff(got, ref).max() <= 1
    if src == (canvas, canvas):
        np.testing.assert_array_equal(got, img)


def test_packed_batch_equals_image_by_image():
    rng = np.random.RandomState(0)
    images = [rng.randint(0, 256, (h, w, 3), np.uint8) for h, w in ((30, 40), (17, 9), (64, 64))]
    offsets, chunks, total = [], [], 0
    for img in images:
        offsets.append(total)
        pad = -img.size % 256
        chunks += [img.ravel(), np.zeros(pad, np.uint8)]
        total += img.size + pad
    src = torch.from_numpy(np.concatenate(chunks))
    meta = torch.tensor([[o, *img.shape[:2]] for o, img in zip(offsets, images)])
    launches, plain = resize_canvas.launches, resize_canvas.plain_calls
    out = resize_canvas(src, meta, 24)
    assert resize_canvas.launches == launches and resize_canvas.plain_calls == plain + 1
    assert out.shape == (3, 24, 24, 3)
    for img, got in zip(images, out):
        torch.testing.assert_close(got, resize_image_plain(torch.from_numpy(img), 24),
                                   rtol=0, atol=0)


def _fix(x):
    return int(x * 65536 + 0.5)


def _libjpeg_rgb_to_ycc(rgb):
    """libjpeg's encoder conversion (``jccolor.c``): Y, Cb, Cr int64."""
    r, g, b = (rgb[..., i].astype(np.int64) for i in range(3))
    bias = (128 << 16) + 32768 - 1
    return ((_fix(0.299) * r + _fix(0.587) * g + _fix(0.114) * b + 32768) >> 16,
            (-_fix(0.16874) * r - _fix(0.33126) * g + _fix(0.5) * b + bias) >> 16,
            (_fix(0.5) * r - _fix(0.41869) * g - _fix(0.08131) * b + bias) >> 16)


@pytest.mark.parametrize("shape", [(96, 128), (37, 53)])
@pytest.mark.parametrize("factor,hs,vs", [(0x221111, 2, 2), (0x211111, 2, 1),
                                          (0x121111, 1, 2), (0x111111, 1, 1)],
                         ids=["420", "422", "440", "444"])
def test_ycc_to_rgb_plain_is_libjpeg_bit_for_bit(factor, hs, vs, shape):
    h, w = shape
    bh, bw = 8 * vs, 8 * hs  # one MCU
    blocks = np.random.RandomState(h + factor % 7).randint(
        0, 256, (-(-h // bh), -(-w // bw), 3)).astype(np.uint8)
    img = np.repeat(np.repeat(blocks, bh, 0), bw, 1)[:h, :w]
    ok, enc = cv2.imencode(".jpg", np.ascontiguousarray(img[:, :, ::-1]),
                           [cv2.IMWRITE_JPEG_QUALITY, 100,
                            cv2.IMWRITE_JPEG_SAMPLING_FACTOR, factor])
    ref = cv2.cvtColor(cv2.imdecode(enc, cv2.IMREAD_COLOR), cv2.COLOR_BGR2RGB)
    y, cb, cr = _libjpeg_rgb_to_ycc(blocks)
    ch, cw = -(-h // vs), -(-w // hs)
    planes = [np.repeat(np.repeat(y, bh, 0), bw, 1)[:h, :w]] + [
        np.repeat(np.repeat(c, 8, 0), 8, 1)[:ch, :cw] for c in (cb, cr)]
    got = ycc_to_rgb_image_plain(*(torch.from_numpy(p.astype(np.uint8)) for p in planes),
                                 hs=hs, vs=vs)
    np.testing.assert_array_equal(got.numpy(), ref)
    if hs * vs > 1:  # chroma replicated without libjpeg's filter is far off
        nearest = ycc_to_rgb_image_plain(torch.from_numpy(planes[0].astype(np.uint8)), *(
            torch.from_numpy(np.repeat(np.repeat(p, vs, 0), hs, 1)[:h, :w].astype(np.uint8))
            for p in planes[1:]), hs=1, vs=1)
        assert _diff(nearest.numpy(), ref).max() > 20


def test_ycc_to_rgb_packed_batch_and_grayscale():
    rng = np.random.RandomState(3)
    images = [(rng.randint(0, 256, (9, 14), np.uint8), rng.randint(0, 256, (5, 7), np.uint8),
               rng.randint(0, 256, (5, 7), np.uint8), 2, 2),
              (rng.randint(0, 256, (6, 10), np.uint8), None, None, 0, 0),
              (rng.randint(0, 256, (6, 10), np.uint8), rng.randint(0, 256, (6, 5), np.uint8),
               rng.randint(0, 256, (6, 5), np.uint8), 2, 1)]
    chunks, meta, at, rgb_at = [], [], 0, 0
    for y, cb, cr, hs, vs in images:
        flat = np.concatenate([p.ravel() for p in (y, cb, cr) if p is not None])
        pad = -flat.size % 256
        ch, cw = cb.shape if cb is not None else (0, 0)
        meta.append([at, *y.shape, cw, ch, hs, vs, rgb_at])
        chunks += [flat, np.zeros(pad, np.uint8)]
        at += flat.size + pad
        rgb_at += -(-3 * y.size // 256) * 256
    launches, plain = ycc_to_rgb.launches, ycc_to_rgb.plain_calls
    out = ycc_to_rgb(torch.from_numpy(np.concatenate(chunks)), torch.tensor(meta), rgb_at, 140)
    assert ycc_to_rgb.launches == launches and ycc_to_rgb.plain_calls == plain + 1
    for (y, cb, cr, hs, vs), m in zip(images, meta):
        planes = [torch.from_numpy(p) for p in (y, cb, cr) if p is not None]
        want = ycc_to_rgb_image_plain(*planes, hs=hs, vs=vs)
        got = out[m[-1]:m[-1] + 3 * y.size].view(*y.shape, 3)
        torch.testing.assert_close(got, want, rtol=0, atol=0)
        if hs == 0:
            assert (got == torch.from_numpy(y)[..., None]).all()


def _kinds():
    gray = cv2.imencode(".jpg", cv2.cvtColor(_image((90, 120), 5), cv2.COLOR_RGB2GRAY))[1]
    png = cv2.imencode(".png", _image((40, 40), 6))[1].tobytes()
    whole = _jpeg((120, 160), seed=7)
    # an APP1 segment holding a whole JPEG (a thumbnail, ending in its own EOI)
    # before the truncated stream's own segments
    thumb = _jpeg((16, 16), seed=10)
    app1 = b"\xff\xe1" + (2 + len(thumb)).to_bytes(2, "big") + thumb
    return {
        "baseline": whole,
        "grayscale": gray.tobytes(),
        "444": _jpeg((90, 120), seed=8, IMWRITE_JPEG_SAMPLING_FACTOR=0x111111),
        "progressive": _jpeg((90, 120), seed=9, IMWRITE_JPEG_PROGRESSIVE=1),
        "restarts": _jpeg((90, 120), seed=11, IMWRITE_JPEG_RST_INTERVAL=2),
        "trailer": whole + b"camera trailer \xff\xd8\xff\x00\x00\x00",
        "truncated": whole[: len(whole) // 3],
        "thumbnail_truncated": whole[:2] + app1 + whole[2: len(whole) // 3],
        "png": png,
        "garbage": b"\xff\xd8definitely-not-a-jpeg",
        "empty": b"",
    }


def test_pool_with_failures():
    kinds = _kinds()
    pool = native.DecodePool("cpu")
    native.reset_counts()
    outs, ok = pool.decode(list(kinds.values()), 48)
    pool.close()
    assert outs.shape == (len(kinds), 48, 48, 3)
    expected = {"baseline": True, "grayscale": True, "444": True, "progressive": True,
                "restarts": True, "trailer": True, "truncated": False,
                "thumbnail_truncated": False, "png": False, "garbage": False, "empty": False}
    assert dict(zip(kinds, ok.tolist())) == expected
    assert native.counts["plain"] == 6 and native.counts["failed"] == 5
    for (kind, data), out, good in zip(kinds.items(), outs, ok):
        if good:
            assert _diff(out, _cv2_ref(data, 48)).max() <= 1, kind
            np.testing.assert_array_equal(out, native.decode_jpeg(data, 48, "cpu"))
        else:
            assert not out.any() and native.decode_jpeg(data, 48, "cpu") is None
    assert native.jpeg_header(kinds["baseline"]) == (120, 160, 3)
    assert native.jpeg_header(kinds["grayscale"]) == (90, 120, 1)
    assert native.jpeg_header(kinds["trailer"]) == (120, 160, 3)
    np.testing.assert_array_equal(outs[list(kinds).index("trailer")], outs[0])


def test_decode_files(tmp_path):
    paths = []
    for i, (kind, data) in enumerate(_kinds().items()):
        paths.append(str(tmp_path / f"{i}_{kind}.jpg"))
        with open(paths[-1], "wb") as f:
            f.write(data)
    paths.append(str(tmp_path / "missing.jpg"))
    outs, ok = native.DecodePool("cpu").decode_files(paths, 40)
    assert ok.tolist() == [True] * 6 + [False] * 6
    assert native.decode_jpeg_file(paths[0], 40, "cpu").shape == (40, 40, 3)
    assert native.decode_jpeg_file(paths[-1], 40, "cpu") is None


class _Dataset(BaseDataset):
    def __len__(self):
        return 0

    def __getitem__(self, idx):
        return None


def test_read_image_takes_cv2_where_the_decode_refuses(tmp_path, monkeypatch):
    """With ``--native-decode`` a JPEG is decoded by the native path; a PNG
    or a truncated JPEG is read by cv2 and counted; a garbage file is None
    (and counted). ``VINCE_NATIVE_DECODE=1`` turns the path on as the flag
    does."""
    kinds = _kinds()
    files = {}
    for kind in ("baseline", "progressive", "trailer", "truncated", "png", "garbage"):
        files[kind] = str(tmp_path / f"{kind}.img")
        with open(files[kind], "wb") as f:
            f.write(kinds[kind])
    c = canvas_size(64)
    flag_on = _Dataset(SimpleNamespace(input_width=64, native_decode=True, platform="cpu"))
    cv2_only = _Dataset(SimpleNamespace(input_width=64, native_decode=False, platform="cpu"))
    native.reset_counts()
    for kind, path in files.items():
        got, ref = flag_on.read_image(path), cv2_only.read_image(path)
        if kind == "garbage":
            assert got is None and ref is None
            continue
        assert got.shape == (c, c, 3) and _diff(got, ref).max() <= 1, kind
        if kind in ("truncated", "png"):  # the cv2 read itself
            np.testing.assert_array_equal(got, ref)
    assert native.counts["cv2_reads"] == 3  # truncated, png, garbage
    assert native.counts["plain"] == 3
    monkeypatch.setenv("VINCE_NATIVE_DECODE", "1")
    native.reset_counts()
    cv2_only.read_image(files["baseline"])
    assert native.counts["plain"] == 1


def test_cuda_entry_points_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    data = _jpeg()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        native.decode_jpeg(data, 64)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        native.DecodePool("cuda")
    ds = _Dataset(SimpleNamespace(input_width=64, native_decode=True, platform="cuda"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ds.read_image(os.devnull)
    assert native.available("cpu") and not native.available("cuda")
    # the solvers make the decode ready before any loader thread starts
    from vince_tpu_torch.solvers.vince_solver import open_native_decode

    with pytest.raises(RuntimeError, match="does not run on cuda"):
        open_native_decode(SimpleNamespace(native_decode=True), torch.device("cuda"))
    open_native_decode(SimpleNamespace(native_decode=True), torch.device("cpu"))
    open_native_decode(SimpleNamespace(native_decode=False), torch.device("cuda"))
