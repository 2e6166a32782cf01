"""What limits the JPEG path's fused kernel (``ycc_resize_canvas`` in
``csrc/jpeg_decode.cu``) on the card: times of one-line variants of its
source, beside the two kernels it replaced.

    python3 vince_tpu_torch/tools/jpeg_variants.py [--source PATH:LABEL ...]

On the planes that nvJPEG decodes from ``chip_smoke.py`` phase 2's JPEGs
(160 frames of 480x360 4:2:0; an R2V2 item's 5 frames; one ImageNet image of
500x375; each to 256x256) it prints, with a cold L2 (``chip_smoke.time_ms``),
the time of each variant, built from the source with one line replaced:

- ``as built``;
- ``rows=K``: bands of K output rows whatever the batch (the kernel picks 8
  for a batch, fewer for a call of few frames);
- ``threads=K``: blocks of K threads (the kernel: 256);
- ``luma only``: every frame converted as grayscale (no chroma read);
- ``no luma read``: the luma not read from the planes (the chroma is);
- ``no lerp``: the output bytes without the interpolation's arithmetic;
- ``no store``: the band not written to the canvas;

then the old pair (``ycc_to_rgb``, then ``resize_canvas``) and each variant
of another copy of the source (``--source PATH:LABEL``, for example the
parent commit's, unpacked into ``_archive/``) as built. A measurement aid:
the port does not import it.
"""

import argparse
import ctypes
import os
import subprocess
import sys
import tempfile

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from chip_smoke import (  # noqa: E402
    R2V2_ITEM_FRAMES, RESIZE_BATCH, RESIZE_CANVAS, RESIZE_FRAME, encode_jpeg, jpeg_pair,
    pair_metas, texture_image, texture_pool, time_ms)
from vince_tpu_torch import native  # noqa: E402
from vince_tpu_torch.ops.kernels import build  # noqa: E402

ROWS = "  const int rows = fused_launch_rows(canvas, n, sms);"
THREADS = "constexpr int THREADS = 256;"
CHROMA = "      if (hs == 0) {"
LUMA = "      const int luma = planes[(long long)y * sw + x];"
LERP = "        o[c] = (uint8_t)__fadd_rn(__fadd_rn(t0, __fmul_rn(wy, __fsub_rn(t1, t0))), 0.5f);"
STORE = ("    reinterpret_cast<uint4*>(dst + head)[i] = "
         "reinterpret_cast<const uint4*>(band + head)[i];")
# name -> (the line of the source it replaces, by what)
VARIANTS = {
    "as built": (ROWS, ROWS),
    **{f"rows={k}": (ROWS, f"  const int rows = min({k}, fused_band_rows(canvas));")
       for k in (1, 2, 4, 8)},
    **{f"threads={k}": (THREADS, f"constexpr int THREADS = {k};") for k in (128, 512)},
    "luma only": (CHROMA, "      if (true) {"),
    "no luma read": (LUMA, "      const int luma = x & 255;"),
    "no lerp": (LERP, "        o[c] = (uint8_t)(a0 + b1);"),
    "no store": (STORE, "    ;"),
}


def build_variants(sources):
    """Every (label, variant) as a shared library, one ``nvcc`` each, all at
    once; {(label, name): the library's path}."""
    out_dir = tempfile.mkdtemp(prefix="jpeg_variants_")
    procs = {}
    for label, path in sources:
        text = open(path).read()
        for name, (old, new) in (VARIANTS.items() if label == "tree" else
                                 [("as built", VARIANTS["as built"])]):
            if old not in text:
                raise RuntimeError(f"{label}: the line of {name!r} is not in {path}")
            stem = os.path.join(out_dir, f"{label}_{len(procs)}")
            with open(stem + ".cu", "w") as f:
                f.write(text.replace(old, new))
            cmd = [build._nvcc(), *build.NVCC_FLAGS, "-o", stem + ".so", stem + ".cu",
                   *build.LINK_FLAGS["jpeg_decode"]]
            procs[(label, name)] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                     stderr=subprocess.STDOUT, text=True),
                                    stem + ".so")
    libs = {}
    for key, (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {key}:\n{log}")
        libs[key] = so
    return libs


def entry(path):
    fn = ctypes.CDLL(path).vince_ycc_resize_canvas
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--source", action="append", default=[], metavar="PATH:LABEL",
                        help="another copy of jpeg_decode.cu, timed as built")
    args = parser.parse_args()
    dev = torch.device("cuda", 0)
    sources = [("tree", os.path.join(build.CSRC_DIR, "jpeg_decode.cu"))]
    sources += [tuple(reversed(s.rsplit(":", 1))) for s in args.source]
    libs = build_variants(sources)
    build.build_all(["jpeg_decode"])
    pool = texture_pool(14)
    rng = np.random.RandomState(14)
    decoder = native.DecodePool(dev)._decoder
    c = RESIZE_CANVAS
    shapes = {f"{RESIZE_BATCH} frames": (RESIZE_FRAME, RESIZE_BATCH),
              f"R2V2 item ({R2V2_ITEM_FRAMES} frames)": (RESIZE_FRAME, R2V2_ITEM_FRAMES),
              "ImageNet image": ((375, 500), 1)}
    inputs = {}
    for what, (hw, n) in shapes.items():
        planes, meta, _, rows = decoder.decode_planes(
            [encode_jpeg(texture_image(pool, rng, hw)) for _ in range(n)])
        decoder.stream.synchronize()
        assert rows == list(range(n)), what
        inputs[what] = (planes, meta, jpeg_pair(planes, pair_metas(meta), c))
    stream = torch.cuda.current_stream(dev).cuda_stream
    print(f"card: {torch.cuda.get_device_name(0)}; ms with a cold L2, canvas {c}; "
          f"'=' where the canvases equal the old pair's")
    for (label, name), path in libs.items():
        fn = entry(path)
        cells = []
        for what, (planes, meta, ref) in inputs.items():
            out = torch.empty(meta.shape[0], c, c, 3, dtype=torch.uint8, device=dev)

            def call():
                build.check(fn(planes.data_ptr(), meta.data_ptr(), meta.shape[0], c,
                               out.data_ptr(), stream), name)

            call()
            torch.cuda.synchronize()
            same = "=" if torch.equal(out, ref) else " "
            cells.append(f"{what} {time_ms(call):.4f}{same}")
        print(f"{label:>8} {name:>10}: " + ", ".join(cells), flush=True)
    cells = []
    for what, (planes, meta, _) in inputs.items():
        metas = pair_metas(meta)
        cells.append(f"{what} {time_ms(lambda: jpeg_pair(planes, metas, c)):.4f}")
    print(f"{'':>8} {'old pair':>10}: " + ", ".join(cells))


if __name__ == "__main__":
    main()
