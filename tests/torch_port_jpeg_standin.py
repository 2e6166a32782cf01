"""A host stand-in of ``vince_tpu_torch/csrc/jpeg_decode.cu``: its kernels'
source compiled by ``g++`` under ``torch_port_jpeg_standin_src/emulate.h`` (one
thread per CUDA thread, the blocks in turn), its decode entry points by
libjpeg (``raw_data_out``: the YCbCr planes nvJPEG would write). So the
kernels' own code runs on the CPU, and the native module's card path can be
driven with the stand-in in place of ``build.load("jpeg_decode")``.

    python tests/torch_port_jpeg_standin.py    # rehearse native/__init__.py's card path

``build()`` returns the loaded library (None where ``g++`` or libjpeg's
headers are missing). The kernels' text is the part of the file from
``upsampled`` to the decoder's state (``START``, ``END``). A module without
JAX.
"""

import contextlib
import ctypes
import functools
import os
import shutil
import subprocess
import sys
import tempfile

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
SOURCE = os.path.join(REPO, "vince_tpu_torch", "csrc", "jpeg_decode.cu")
START = "// One chroma plane upsampled"
END = "// two decode states, used in turn"
STANDIN = os.path.join(HERE, "torch_port_jpeg_standin_src")


@functools.lru_cache(maxsize=None)
def build():
    """The stand-in, built into a temporary directory and loaded; None where
    it cannot be built here."""
    if shutil.which("g++") is None:
        return None
    text = open(SOURCE).read()
    threads = next(line for line in text.splitlines() if line.startswith("constexpr int THREADS"))
    out = tempfile.mkdtemp(prefix="jpeg_standin_")
    cpp = os.path.join(out, "standin.cpp")
    with open(cpp, "w") as f:
        f.write('#include "emulate.h"\n' + threads + "\n"
                + text[text.index(START):text.index(END)] + '#include "entries.cpp"\n')
    lib = os.path.join(out, "libstandin.so")
    done = subprocess.run(["g++", "-O2", "-ffp-contract=off", "-std=c++17", "-shared", "-fPIC",
                           "-pthread", "-I", STANDIN, "-o", lib, cpp, "-ljpeg"],
                          capture_output=True, text=True)
    if done.returncode:
        if "jpeglib.h" in done.stderr:
            return None
        raise RuntimeError(f"g++ failed on the stand-in:\n{done.stderr}")
    lib = ctypes.CDLL(lib)
    lib.vince_ycc_resize_canvas_rows.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                                                 ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    return lib


def fused(lib, src: torch.Tensor, meta: torch.Tensor, canvas: int, rows: int = 0):
    """The fused kernel's code on the CPU tensors (``rows`` > 0 fixes the
    band's rows)."""
    out = torch.empty(meta.shape[0], canvas, canvas, 3, dtype=torch.uint8)
    status = lib.vince_ycc_resize_canvas_rows(src.data_ptr(), meta.data_ptr(), meta.shape[0],
                                              canvas, rows, out.data_ptr())
    if status:
        raise ValueError(f"the stand-in refused meta {tuple(meta.shape)}, canvas {canvas}")
    return out


@contextlib.contextmanager
def card_path(lib):
    """``vince_tpu_torch.native``'s card path on the CPU: the stand-in in place
    of the built library, torch.cuda's device and stream contexts stubbed,
    pinned memory taken as plain memory, the fused wrapper launching the
    stand-in's kernel. Yields a log of the decode's meta copies (their
    ``non_blocking``), pinnings and stream synchronises."""
    from vince_tpu_torch import native
    from vince_tpu_torch.ops.kernels import build as kernels_build
    from vince_tpu_torch.ops.kernels import jpeg_kernels

    log = {"to": [], "pin": 0, "sync": 0}

    class Stream:
        cuda_stream = 0

        def __init__(self, *args):
            pass

        def synchronize(self):
            log["sync"] += 1

    def to(tensor, *args, **kwargs):
        log["to"].append(kwargs.get("non_blocking", False))
        return saved["to"](tensor, *args, **kwargs)

    def pin(tensor):
        log["pin"] += 1
        return tensor.clone()

    def empty(*args, pin_memory=False, **kwargs):
        return saved["empty"](*args, **kwargs)

    saved = {"to": torch.Tensor.to, "pin": torch.Tensor.pin_memory, "empty": torch.empty,
             "device": torch.cuda.device, "stream": torch.cuda.stream,
             "Stream": torch.cuda.Stream, "current_stream": torch.cuda.current_stream,
             "load": kernels_build.load, "use_kernel": jpeg_kernels.use_kernel}
    torch.cuda.device = lambda device: contextlib.nullcontext()
    torch.cuda.stream = lambda stream: contextlib.nullcontext()
    torch.cuda.Stream = Stream
    torch.cuda.current_stream = lambda device=None: Stream()
    torch.Tensor.to, torch.Tensor.pin_memory, torch.empty = to, pin, empty
    kernels_build.load = lambda name: lib
    jpeg_kernels.use_kernel = lambda tensor: True
    native._library.cache_clear()
    jpeg_kernels._fused_entry.cache_clear()
    try:
        yield log
    finally:
        torch.Tensor.to, torch.Tensor.pin_memory = saved["to"], saved["pin"]
        torch.empty = saved["empty"]
        torch.cuda.device, torch.cuda.stream = saved["device"], saved["stream"]
        torch.cuda.Stream, torch.cuda.current_stream = saved["Stream"], saved["current_stream"]
        kernels_build.load = saved["load"]
        jpeg_kernels.use_kernel = saved["use_kernel"]
        native._library.cache_clear()
        jpeg_kernels._fused_entry.cache_clear()


def rehearse(canvases=(32, 70)):
    """native/__init__.py's card path on the stand-in: each decode call makes
    one meta copy (non-blocking, from a pinned tensor), one launch of the
    fused kernel and one stream synchronise; the canvases equal the plain
    version's on the same planes and cv2's decode + the plain resize."""
    import cv2

    from vince_tpu_torch import native
    from vince_tpu_torch.ops.kernels import jpeg_kernels

    def encode(h, w, seed, factor=None, gray=False):
        rng = np.random.RandomState(seed)
        img = cv2.resize(rng.randint(0, 256, (6, 8, 3), np.uint8), (w, h),
                         interpolation=cv2.INTER_CUBIC)
        if gray:
            img = cv2.cvtColor(img, cv2.COLOR_BGR2GRAY)
        flags = [cv2.IMWRITE_JPEG_QUALITY, 90]
        flags += [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, factor] if factor else []
        return cv2.imencode(".jpg", img, flags)[1].tobytes()

    lib = build()
    if lib is None:
        raise RuntimeError("the stand-in needs g++ and libjpeg's headers")
    items = [encode(48, 64, 0), encode(41, 57, 1), encode(30, 40, 2, gray=True),
             encode(33, 27, 3, 0x111111), encode(29, 35, 4, 0x211111),
             encode(40, 30, 5, 0x121111), b"\xff\xd8junk", encode(50, 70, 6)[:200]]
    takes = [True] * 6 + [False] * 2
    with card_path(lib) as log:
        decoder = native._CardDecoder(torch.device("cpu"))
        for canvas in canvases:
            for key in log:
                log[key] = [] if key == "to" else 0
            before = {name: w.launches for name, w in native._KERNELS.items()}
            outs, ok = decoder.decode(items, canvas)
            moved = {name: w.launches - before[name] for name, w in native._KERNELS.items()}
            print(f"canvas {canvas}: ok {ok.tolist()}, launches {moved}, meta copies "
                  f"(non_blocking) {log['to']}, pinned {log['pin']}, synchronises {log['sync']}")
            assert ok.tolist() == takes
            assert log == {"to": [True], "pin": 1, "sync": 1}
            assert moved == {"ycc_resize_canvas": 1, "ycc_to_rgb": 0, "resize_canvas": 0}
            planes, meta, _, rows = decoder.decode_planes(items)
            assert rows == list(range(6))
            plain = jpeg_kernels._reference_ycc_resize(planes, meta, canvas).numpy()
            assert np.array_equal(plain, outs[:6])
            for i in range(6):
                bgr = cv2.imdecode(np.frombuffer(items[i], np.uint8), cv2.IMREAD_COLOR)
                rgb = torch.from_numpy(np.ascontiguousarray(bgr[:, :, ::-1]))
                want = jpeg_kernels.resize_image_plain(rgb, canvas).numpy()
                d = np.abs(want.astype(int) - outs[i].astype(int))
                print(f"  frame {i}: against cv2 + the plain resize mean {d.mean():.4f}, "
                      f"max {d.max()}")
                assert d.mean() < 1 and d.max() <= 2
        log["to"] = []
        outs, ok = decoder.decode([b"\xff\xd8junk"], 16)  # none decoded: no meta, no launch
        assert not ok.any() and not outs.any() and log["to"] == []
    print("the card path on the stand-in: OK")


if __name__ == "__main__":
    sys.path.insert(0, REPO)
    rehearse()
