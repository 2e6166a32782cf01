"""What limits the depthwise kernel (K4) and its filter-gradient kernel on the
card: times of one-line variants of ``csrc/depthwise_conv.cu`` and of other
tiles, and the opcode mix of both kernels.

    python3 vince_tpu_torch/tools/depthwise_variants.py        # from the repo's root

For each site shape of EfficientNet-B0 it prints, with a cold L2:

- the forward kernel as built (``fma``: one fused multiply-add per tap, which
  for bf16 is the plain version's value); ``exact`` (a rounded product and a
  rounded sum per tap: the same bits from twice the arithmetic);
  ``uncapped`` (compiled for up to 255 registers a thread instead of 128:
  nothing re-computed to save registers, half the CTAs on an SM); ``copy``
  (no taps: the centre column stored, the floor of this staging and store
  pattern); ``Tensor.copy_``;
- the filter gradient as built;
- for both kernels, a sweep over the tile's parameters, which are arguments of
  the C entry points and keyword arguments of ``depthwise_kernel._tiling``:
  images and rows per CTA, columns per thread, channels per CTA, images side
  by side; each line gives the time and the tile it led to;

and at the end the SASS opcode counts of the bf16 k=5 bodies (2 channels and 4
columns a thread, 16-byte copies) of both kernels, floats against integers. A
measurement aid: the port does not import it.
"""

import collections
import ctypes
import os
import re
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from chip_smoke import K4_SHAPES, time_ms  # noqa: E402
from vince_tpu_torch.ops.kernels import build  # noqa: E402
from vince_tpu_torch.ops.kernels import depthwise_kernel as k4  # noqa: E402

TAP = "    return fmaf(tap, weight, acc);"
CALL = "a = add_tap<T>(a, cur[q + j][e], wk[i][j][e]);"
BOUNDS = "__launch_bounds__(MAX_THREADS, 2)\ndw_kernel"
# name -> the line of the source it replaces, and by what
VARIANTS = {
    "fma": (TAP, TAP),
    "exact": (TAP, "    return __fadd_rn(acc, __fmul_rn(tap, weight));"),
    "copy": (CALL, "if (i == K - 1 && j == 0) a = cur[q + K / 2][e];"),
    "uncapped": (BOUNDS, "__launch_bounds__(MAX_THREADS)\ndw_kernel"),
}
# one choice at a time, away from what _tiling picks
SWEEP = [dict(images=i) for i in (1, 2, 4, 8, 16)] + \
        [dict(band_rows=b) for b in (7, 14, 28, 56, 112)] + \
        [dict(cols=c) for c in (2, 4, 8)] + \
        [dict(chunk=c) for c in (16, 32, 48, 64, 96, 128)] + \
        [dict(cols=2, chunk=c) for c in (32, 64, 128)] + \
        [dict(slots=s) for s in (1, 2, 4, 8)]
FLOAT_OPS = ("FMUL", "FADD", "FFMA", "HMUL2", "HFMA2", "HADD2", "F2FP", "F2F")
INTEGER_OPS = ("IMAD", "IADD3", "LEA", "SHF", "LOP3", "ISETP", "PRMT", "MOV", "SEL", "IABS",
               "I2F", "F2I", "SHL", "SHR", "VIADD", "UIADD3", "UIMAD", "UMOV", "ULOP3", "USHF",
               "UISETP", "ULEA")


def build_variants():
    source = (build.CSRC_DIR / "depthwise_conv.cu").read_text()
    if any(source.count(line) != 1 for line in (TAP, CALL, BOUNDS)):
        raise RuntimeError("the lines of depthwise_conv.cu that the variants replace have changed")
    out_dir = build.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, (old, new) in VARIANTS.items():
        src, lib = out_dir / f"dw_{name}.cu", out_dir / f"dw_{name}.so"
        src.write_text(source.replace(old, new))
        procs[name] = (lib, subprocess.Popen([build._nvcc(), *build.NVCC_FLAGS, "-o", str(lib),
                                              str(src)]))
    libs = {}
    for name, (lib, proc) in procs.items():
        if proc.wait() != 0:
            raise RuntimeError(f"nvcc failed for the {name} variant")
        libs[name] = ctypes.CDLL(str(lib))
        libs[name].vince_depthwise_conv.argtypes = (
            [ctypes.c_void_p] * 3 + [ctypes.c_int] * 15 + [ctypes.c_void_p])
        libs[name].vince_depthwise_wgrad.argtypes = (
            [ctypes.c_void_p] * 4 + [ctypes.c_int] * 15 + [ctypes.c_void_p])
    return libs, out_dir / "dw_fma.cu"


def sass_counts(src, dump_dir=None):
    """Opcode counts of the two bf16 k=5 kernels with 4 columns and 2 channels
    a thread and 16-byte copies: of each whole kernel, and of its row body (from
    the first to the last multiply: the taps of the staged rows of one trip of
    the row loop with what lies between them). ``dump_dir`` gets the two listings."""
    cubin = str(src.with_suffix(".cubin"))
    flags = [f for f in build.NVCC_FLAGS if f not in ("-shared", "-Xcompiler", "-fPIC")]
    subprocess.run([build._nvcc(), *flags, "-cubin", "-o", cubin, str(src)], check=True)
    cuobjdump = os.path.join(os.path.dirname(build._nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", cubin], capture_output=True, text=True,
                          check=True).stdout
    counts = {}
    for kernel in ("9dw_kernel", "15dw_wgrad_kernel"):
        name = kernel[kernel.index("dw"):]
        listing = re.search(r"Function : \S*" + kernel
                            + r"I13__nv_bfloat16Li5ELi4ELi2ELi16E.*?(?=Function :|\Z)",
                            sass, re.S).group(0)
        if dump_dir:
            os.makedirs(dump_dir, exist_ok=True)
            with open(os.path.join(dump_dir, f"sass_{name}.txt"), "w") as f:
                f.write(listing)
        full = re.findall(r"/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", listing)
        # the compiler also writes a register move as HFMA2.MMA R, -RZ, RZ, imm
        ops = ["MOV" if op.startswith("HFMA2") and "BF16" not in op else op.split(".")[0]
               for op in full]
        products = [i for i, op in enumerate(ops) if op in ("FMUL", "FFMA", "HMUL2", "HFMA2")]
        counts[name] = (collections.Counter(ops),
                        collections.Counter(ops[products[0]:products[-1] + 1]))
    return counts


def main():
    if not torch.cuda.is_available():
        sys.exit("no CUDA device")
    libs, built_src = build_variants()
    stream = torch.cuda.current_stream().cuda_stream
    for n, h, w, c, k, _, blocks in K4_SHAPES:
        x = torch.randn(n, h, w, c, device="cuda").bfloat16()
        g = torch.randn(n, h, w, c, device="cuda").bfloat16()
        wt = (torch.randn(k, k, 1, c, device="cuda") * 0.2).bfloat16()
        out, y = torch.empty_like(x), torch.empty_like(x)
        dw = torch.empty(k, k, 1, c, device="cuda")

        def forward(name, tile):
            status = libs[name].vince_depthwise_conv(
                x.data_ptr(), wt.data_ptr(), out.data_ptr(), n, h, w, c, k, 1,
                *tile.launch_args, stream)
            if status != 0:
                raise RuntimeError(f"CUDA error {status}")

        def wgrad(tile):
            part = torch.empty(tile.parts, k * k, c, device="cuda")
            status = libs["fma"].vince_depthwise_wgrad(
                x.data_ptr(), g.data_ptr(), part.data_ptr(), dw.data_ptr(), n, h, w, c, k, 1,
                *tile.launch_args, stream)
            if status != 0:
                raise RuntimeError(f"CUDA error {status}")

        print(f"x [{n},{h},{w},{c}] k={k} ({blocks})", flush=True)
        tile, tile_w = k4._tiling(n, h, w, c, k, 2, False), k4._tiling(n, h, w, c, k, 2, True)
        times = {name: time_ms(lambda: forward(name, tile), iters=10, warmup=2)
                 for name in libs}
        times["Tensor.copy_"] = time_ms(lambda: y.copy_(x), iters=10, warmup=2)
        print("  forward: " + ", ".join(f"{name} {t:.4f} ms" for name, t in times.items())
              + f"; {tile}")
        print(f"  wgrad: {time_ms(lambda: wgrad(tile_w), iters=10, warmup=2):.4f} ms; {tile_w}")
        for is_wgrad, label in ((False, "forward"), (True, "wgrad")):
            seen, rows, uncapped = {tile_w if is_wgrad else tile}, [], []
            for choice in SWEEP:
                if choice.get("band_rows", 0) > h:
                    continue
                try:
                    t = k4._tiling(n, h, w, c, k, 2, is_wgrad, **choice)
                except ValueError:
                    continue
                if t in seen or t.threads > k4.MAX_THREADS or t.smem_bytes > k4.SMEM_LIMIT:
                    continue
                seen.add(t)
                run = (lambda: wgrad(t)) if is_wgrad else (lambda: forward("fma", t))
                rows.append((time_ms(run, iters=5, warmup=1), choice, t))
                if not is_wgrad:
                    uncapped.append((time_ms(lambda: forward("uncapped", t), iters=5, warmup=1),
                                     t))
            for ms, choice, t in sorted(rows, key=lambda r: r[0]):
                print(f"    {label} {ms:.4f} ms with {choice}: cols={t.cols} chunk={t.chunk} "
                      f"groups={t.groups} slots={t.slots} images={t.images} "
                      f"band_rows={t.band_rows} threads={t.threads} "
                      f"ctas={t.ctas}", flush=True)
            if uncapped:
                ms, t = min(uncapped, key=lambda r: r[0])
                print(f"    forward, uncapped registers, best of the sweep: {ms:.4f} ms with {t}")
    for kernel, both in sass_counts(built_src, os.path.join(ROOT, "chiprun_out")).items():
        for part, counts in zip(("whole kernel", "row body"), both):
            floats = sum(counts[op] for op in FLOAT_OPS)
            integers = sum(counts[op] for op in INTEGER_OPS)
            print(f"SASS of {kernel}<bf16, k=5, 4 columns, 2 channels, 16-byte copies>, {part}: "
                  f"{sum(counts.values())} opcodes, {floats} float, {integers} integer and "
                  "move: " + ", ".join(f"{op} {n}" for op, n in counts.most_common(16)))


if __name__ == "__main__":
    main()
