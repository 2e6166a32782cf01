"""JPEG decode to the square RGB canvas (counterpart of
``vince_tpu/native/__init__.py``), behind ``--native-decode``.

On a CUDA device the decode runs on the card: nvJPEG's default backend
decodes at full size into YCbCr planes in a device buffer; the
hand-written kernels of ``ops/kernels/jpeg_kernels.py`` upsample the chroma
and convert to RGB as libjpeg (and so cv2) does, then resize to the canvas
with ``vince_tpu/native/decode.cc``'s formula; one copy brings the canvases
to pinned host memory, so that the datasets keep handing numpy arrays. A
build or launch failure raises: nothing decodes on the host because the card
failed. On the CPU the entry points run the plain version: ``cv2.imdecode``
at full size, then the resize's plain PyTorch version.

A stream either path does not take (not a JPEG whose segments and scans run
from its start marker to its end marker, as a truncated file's do not; not 1
or 3 components; a chroma layout other than 4:4:4, 4:2:2, 4:2:0, 4:4:0 or
grayscale; rejected by nvJPEG as a bad, unsupported or incomplete stream)
comes back as ``None`` or ``ok = False``; ``read_image`` then reads the file
with ``cv2`` and counts it (``counts["cv2_reads"]``), as the JAX package
falls back per file. Any other nvJPEG status is a failure of the library or
the card, and raises.

nvJPEG's decode state is not thread-safe: each host thread that decodes gets
its own decoder (two decode states and a CUDA stream of its own), so the
loader's threads decode side by side. ``DecodePool`` holds one decoder and
decodes a batch in one call. Under ``--loader-processes`` each worker
process decodes for itself, on its own CUDA context on the device that the
parent fixed; the counters it moves (``decode_counters``) travel back with
each batch and are added to the parent's (``add_counters``).
"""

import ctypes
import functools
import os
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from vince_tpu_torch.device import resolve_device
from vince_tpu_torch.ops.kernels import build
from vince_tpu_torch.ops.kernels.jpeg_kernels import resize_canvas, ycc_to_rgb

# the files handed to the decode (decode_jpeg_files, DecodePool.decode_files),
# the decodes by path ("nvjpeg": on the card, "plain": the CPU's plain
# version), the streams refused, and the reads that took cv2 instead (reset by
# reset_counts)
counts = {"files": 0, "nvjpeg": 0, "plain": 0, "failed": 0, "cv2_reads": 0}
# the kernels of the card's decode, whose wrappers count their launches and
# plain calls
_KERNELS = {"ycc_to_rgb": ycc_to_rgb, "resize_canvas": resize_canvas}
_NVJPEG_ERROR = 1000  # jpeg_decode.cu returns 1000 + an nvjpegStatus_t
_REFUSED = -1  # jpeg_decode.cu: nvJPEG rejected the stream itself
_counts_lock = threading.Lock()
_ALIGN = 256  # the alignment of each image in the device buffers


def _aligned(nbytes: int) -> int:
    return -(-nbytes // _ALIGN) * _ALIGN


def count(key: str, n: int = 1):
    with _counts_lock:
        counts[key] += n


def reset_counts():
    with _counts_lock:
        for key in counts:
            counts[key] = 0


def decode_counters() -> Dict[str, int]:
    """Every counter that the decode moves in this process: ``counts``, and
    the launches and plain calls of its kernels' wrappers
    (``"ycc_to_rgb.launches"``, ...)."""
    with _counts_lock:
        out = dict(counts)
    for name, wrapper in _KERNELS.items():
        out[f"{name}.launches"] = wrapper.launches
        out[f"{name}.plain_calls"] = wrapper.plain_calls
    return out


def counters_since(before: Dict[str, int]) -> Dict[str, int]:
    """What ``decode_counters`` moved since ``before``: the counters that a
    loader's worker process hands back with a batch."""
    return {k: v - before[k] for k, v in decode_counters().items() if v != before[k]}


def add_counters(moved: Dict[str, int]):
    """Add a worker process's ``counters_since`` to this process's counters."""
    with _counts_lock:
        for key, n in moved.items():
            name, _, attr = key.partition(".")
            if attr:
                setattr(_KERNELS[name], attr, getattr(_KERNELS[name], attr) + n)
            else:
                counts[key] += n


def wanted(args) -> bool:
    """``--native-decode``, or ``VINCE_NATIVE_DECODE=1`` in the environment."""
    return bool(getattr(args, "native_decode", False)) or bool(
        int(os.environ.get("VINCE_NATIVE_DECODE", "0") or 0))


def _standalone(marker: int) -> bool:
    """A marker without a length field: TEM, or a restart RST0-7."""
    return marker == 0x01 or 0xD0 <= marker <= 0xD7


def jpeg_header(data: bytes) -> Optional[Tuple[int, int, int]]:
    """(height, width, components) from the frame header of a JPEG stream
    that reaches its end marker (EOI), else None (a truncated file reaches
    none; a PNG has no start marker). EOI is found at the stream's end or,
    where bytes follow it (camera and editor trailers), by walking the
    segments and entropy-coded scans up to it; what follows is not read."""
    n = len(data)
    if n < 4 or data[:2] != b"\xff\xd8":
        return None
    # most streams end in EOI (trailing NULs aside): then the walk stops at the
    # first scan, and only a stream with bytes after EOI has its scans walked
    ends_in_eoi = data.rstrip(b"\x00").endswith(b"\xff\xd9")
    frame = None
    pos = 2
    while pos + 2 <= n:
        if data[pos] != 0xFF:
            return None
        marker = data[pos + 1]
        if marker == 0xFF:  # fill byte
            pos += 1
            continue
        if marker == 0xD9:  # EOI
            return frame
        if _standalone(marker):
            pos += 2
            continue
        if pos + 4 > n:
            return None
        end = pos + 2 + int.from_bytes(data[pos + 2:pos + 4], "big")
        if end > n:
            return None
        if 0xC0 <= marker <= 0xCF and marker not in (0xC4, 0xC8, 0xCC):
            if end < pos + 10:
                return None
            h = int.from_bytes(data[pos + 5:pos + 7], "big")
            w = int.from_bytes(data[pos + 7:pos + 9], "big")
            frame = h, w, data[pos + 9]
        pos = end
        if marker == 0xDA:  # a scan: its entropy-coded data runs to the next marker
            if frame is None or ends_in_eoi:
                return frame
            while True:
                pos = data.find(b"\xff", pos)
                if pos < 0 or pos + 1 >= n:
                    return None
                nxt = data[pos + 1]
                if nxt == 0x00 or 0xD0 <= nxt <= 0xD7:  # a stuffed 0xFF, a restart
                    pos += 2
                elif nxt == 0xFF:  # fill bytes before a marker
                    pos += 1
                else:
                    break
    return None


def available(device="cuda") -> bool:
    """Whether the decode runs on ``device``: on the CPU where ``cv2``
    imports; on a CUDA device where one is present, after building and
    loading the library (a build failure raises)."""
    device = torch.device(device)
    if device.type == "cpu":
        try:
            import cv2  # noqa: F401
        except ImportError:
            return False
        return True
    if not torch.cuda.is_available():
        return False
    _library()
    return True


@functools.lru_cache(maxsize=None)
def _library():
    lib = build.load("jpeg_decode")
    lib.vince_jpeg_decoder_new.argtypes = [ctypes.POINTER(ctypes.c_void_p)]
    lib.vince_jpeg_decoder_new.restype = ctypes.c_int
    lib.vince_jpeg_decoder_free.argtypes = [ctypes.c_void_p]
    lib.vince_jpeg_decoder_free.restype = None
    lib.vince_jpeg_info.argtypes = [ctypes.c_char_p, ctypes.c_size_t,
                                    ctypes.POINTER(ctypes.c_int)]
    lib.vince_jpeg_info.restype = ctypes.c_int
    lib.vince_jpeg_decode.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                      ctypes.POINTER(ctypes.c_char_p),
                                      ctypes.POINTER(ctypes.c_size_t),
                                      ctypes.POINTER(ctypes.c_void_p),
                                      ctypes.POINTER(ctypes.c_int),
                                      ctypes.POINTER(ctypes.c_int), ctypes.c_void_p]
    lib.vince_jpeg_decode.restype = ctypes.c_int
    return lib


def _check(status: int, what: str):
    """Raise if a jpeg_decode.cu entry point failed: an nvJPEG status of the
    library or the card, or a CUDA error."""
    if status >= _NVJPEG_ERROR:
        raise RuntimeError(f"{what}: nvJPEG status {status - _NVJPEG_ERROR}")
    build.check(status, what)


class _CardDecoder:
    """One nvJPEG decoder (two decode states used in turn, ``jpeg_decode.cu``)
    and one CUDA stream, for one host thread."""

    def __init__(self, device: torch.device):
        self.device = device
        self._lib = _library()
        handle = ctypes.c_void_p()
        with torch.cuda.device(device):  # the decoder's events belong to the stream's device
            _check(self._lib.vince_jpeg_decoder_new(ctypes.byref(handle)), "nvJPEG decoder")
        self._handle = handle
        self.stream = torch.cuda.Stream(device)

    def __del__(self):
        handle = getattr(self, "_handle", None)
        if handle:
            self._lib.vince_jpeg_decoder_free(handle)

    def _info(self, data: bytes) -> Optional[Tuple[int, ...]]:
        """vince_jpeg_info's 8 fields, None for a stream this path refuses."""
        if jpeg_header(data) is None:
            return None
        info = (ctypes.c_int * 8)()
        status = self._lib.vince_jpeg_info(data, len(data), info)
        if status == _REFUSED:
            return None
        _check(status, "nvjpegGetImageInfo")
        components, _, w, h, cw, ch, hs, vs = info
        if components not in (1, 3) or hs < 0 or w <= 0 or h <= 0:
            return None
        return tuple(info)

    def decode_planes(self, items: Sequence[bytes]):
        """nvJPEG's decode on the card, on this decoder's stream (the caller
        synchronises it): (the planes' buffer, ``ycc_to_rgb``'s meta [m, 8] on
        the device, the RGB buffer's bytes, the largest image's pixels,
        ``resize_canvas``'s meta [m, 3] on the device, the indices of
        ``items`` decoded); the metas are None where none was."""
        infos = [(i, self._info(data)) for i, data in enumerate(items)]
        infos = [(i, info) for i, info in infos if info is not None]
        count("failed", len(items) - len(infos))
        plane_at, rgb_at, planes_total, rgb_total = [], [], 0, 0
        for _, (components, _, w, h, cw, ch, _, _) in infos:
            plane_at.append(planes_total)
            rgb_at.append(rgb_total)
            planes_total += _aligned(h * w + (2 * ch * cw if components == 3 else 0))
            rgb_total += _aligned(3 * h * w)
        m = len(infos)
        with torch.cuda.device(self.device), torch.cuda.stream(self.stream):
            planes = torch.empty(max(planes_total, 1), dtype=torch.uint8, device=self.device)
            if not m:
                return planes, None, 0, 0, None, []
            base = planes.data_ptr()
            decoded = (ctypes.c_int * m)()
            status = self._lib.vince_jpeg_decode(
                self._handle, m, (ctypes.c_char_p * m)(*[items[i] for i, _ in infos]),
                (ctypes.c_size_t * m)(*[len(items[i]) for i, _ in infos]),
                (ctypes.c_void_p * m)(*[base + o for o in plane_at]),
                (ctypes.c_int * (8 * m))(*[v for _, info in infos for v in info]), decoded,
                self.stream.cuda_stream)
            _check(status, "vince_jpeg_decode")
            done = [j for j in range(m) if decoded[j]]
            count("nvjpeg", len(done))
            count("failed", m - len(done))
            if not done:
                return planes, None, 0, 0, None, []
            # (planes' offset, h, w, cw, ch, hs, vs, RGB offset) from (c, css, w, h, cw, ch, hs, vs)
            ycc_meta = torch.tensor([[plane_at[j], infos[j][1][3], infos[j][1][2],
                                      *infos[j][1][4:8], rgb_at[j]] for j in done],
                                    dtype=torch.int64)
            resize_meta = ycc_meta[:, [7, 1, 2]].contiguous()
            ycc_meta, resize_meta = ycc_meta.to(self.device), resize_meta.to(self.device)
        pixels = max(infos[j][1][2] * infos[j][1][3] for j in done)
        return planes, ycc_meta, rgb_total, pixels, resize_meta, [infos[j][0] for j in done]

    def decode(self, items: Sequence[bytes], canvas: int) -> Tuple[np.ndarray, np.ndarray]:
        n = len(items)
        ok = np.zeros(n, bool)
        with torch.cuda.device(self.device), torch.cuda.stream(self.stream):
            planes, ycc_meta, rgb_total, pixels, meta, rows = self.decode_planes(items)
            if not rows:
                return np.zeros((n, canvas, canvas, 3), np.uint8), ok
            canvases = resize_canvas(ycc_to_rgb(planes, ycc_meta, rgb_total, pixels), meta, canvas)
            host = torch.empty(canvases.shape, dtype=torch.uint8, pin_memory=True)
            host.copy_(canvases, non_blocking=True)
            self.stream.synchronize()
        ok[rows] = True
        if len(rows) == n:
            return host.numpy(), ok
        out = np.zeros((n, canvas, canvas, 3), np.uint8)
        out[rows] = host.numpy()
        return out, ok


def _plain_decode(data: bytes, canvas: int) -> Optional[np.ndarray]:
    """The plain version: ``cv2.imdecode`` at full size, then the resize's
    wrapper on the CPU tensor (its plain PyTorch version); None where the
    card's path refuses the stream."""
    import cv2

    header = jpeg_header(data)
    if header is None or header[2] not in (1, 3):
        return None
    bgr = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
    if bgr is None:
        return None
    h, w = bgr.shape[:2]
    rgb = torch.from_numpy(np.ascontiguousarray(bgr[:, :, ::-1]).reshape(-1))
    return resize_canvas(rgb, torch.tensor([[0, h, w]]), canvas)[0].numpy()


_local = threading.local()


def _thread_decoder(device: torch.device) -> _CardDecoder:
    decoders = getattr(_local, "decoders", None)
    if decoders is None:
        decoders = _local.decoders = {}
    if device not in decoders:
        decoders[device] = _CardDecoder(device)
    return decoders[device]


def _device(device) -> torch.device:
    device = resolve_device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def _plain_batch(items: Sequence[bytes], canvas: int) -> Tuple[np.ndarray, np.ndarray]:
    outs = np.zeros((len(items), canvas, canvas, 3), np.uint8)
    ok = np.zeros(len(items), bool)
    for i, data in enumerate(items):
        img = _plain_decode(data, canvas)
        if img is not None:
            outs[i], ok[i] = img, True
    count("plain", int(ok.sum()))
    count("failed", len(items) - int(ok.sum()))
    return outs, ok


def decode_jpegs(items: Sequence[bytes], canvas: int, device="cuda"
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """[n] JPEG buffers → ([n, canvas, canvas, 3] uint8, [n] ok mask), in one
    batch on this thread's decoder of a CUDA device, by the plain version on
    the CPU."""
    device = _device(device)
    if device.type == "cpu":
        return _plain_batch(items, canvas)
    return _thread_decoder(device).decode(items, canvas)


def decode_jpeg(data: bytes, canvas: int, device="cuda") -> Optional[np.ndarray]:
    """A JPEG byte buffer → RGB uint8 [canvas, canvas, 3], None if refused."""
    outs, ok = decode_jpegs([data], canvas, device)
    return outs[0] if ok[0] else None


def _read(path: str) -> bytes:
    try:
        with open(path, "rb") as f:
            return f.read()
    except OSError:
        return b""


def decode_jpeg_file(path: str, canvas: int, device="cuda") -> Optional[np.ndarray]:
    return decode_jpeg(_read(path), canvas, device)


def decode_jpeg_files(paths: Sequence[str], canvas: int, device="cuda"
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """``decode_jpegs`` of the files' bytes (a file that cannot be read is not
    ok), counted in ``counts["files"]`` once decoded."""
    out = decode_jpegs([_read(p) for p in paths], canvas, device)
    count("files", len(paths))
    return out


class DecodePool:
    """Batched decode on ``device`` (counterpart of the JAX package's thread
    pool): on a CUDA device one decoder of its own; on the CPU the plain
    version, item by item. One caller at a time (a lock serialises the
    batches of several threads)."""

    def __init__(self, device="cuda"):
        self.device = _device(device)
        self._decoder = _CardDecoder(self.device) if self.device.type == "cuda" else None
        self._submit_lock = threading.Lock()

    def close(self):
        self._decoder = None

    def decode(self, items: Sequence[bytes], canvas: int) -> Tuple[np.ndarray, np.ndarray]:
        """[n] JPEG buffers → ([n, canvas, canvas, 3] uint8, [n] ok mask)."""
        with self._submit_lock:
            if self._decoder is not None:
                return self._decoder.decode(items, canvas)
            return _plain_batch(items, canvas)

    def decode_files(self, paths: List[str], canvas: int) -> Tuple[np.ndarray, np.ndarray]:
        """[n] file paths → ([n, canvas, canvas, 3] uint8, [n] ok mask)."""
        out = self.decode([_read(p) for p in paths], canvas)
        count("files", len(paths))
        return out
