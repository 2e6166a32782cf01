"""What limits the depthwise kernel (K4) on the card: times of one-line
variants of ``csrc/depthwise_conv.cu`` and of other tilings, and the
opcode mix of its inner loop.

    python3 vince_tpu_torch/tools/depthwise_variants.py        # from the repo's root

For the largest B0 sites it prints, with a cold L2: the kernel as built
(``exact``: a rounded product and a rounded sum per tap); ``fma`` (one fused
multiply-add per tap: half the arithmetic, not bit-equal); ``copy`` (no taps:
the centre column copied, the floor of this access pattern); ``Tensor.copy_``;
the best and worst of a sweep over channels per thread, channel vectors per
CTA and rows per band, which are arguments of the C entry point; and the SASS
opcode counts of the bf16 k=5 two-channel kernel. A measurement aid: the port
does not import it.
"""

import collections
import ctypes
import itertools
import os
import re
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from chip_smoke import time_ms  # noqa: E402
from vince_tpu_torch.ops.kernels import build  # noqa: E402
from vince_tpu_torch.ops.kernels import depthwise_kernel as k4  # noqa: E402

TAP = "acc[i][e] = __fadd_rn(acc[i][e], __fmul_rn(cur[j][e], wk[i][j][e]));"
VARIANTS = {
    "exact": TAP,
    "fma": "acc[i][e] = fmaf(cur[j][e], wk[i][j][e], acc[i][e]);",
    "copy": "if (i == 0 && j == 0) acc[i][e] = cur[K / 2][e];",
}
SITES = [(128, 112, 112, 32, 3), (128, 56, 56, 144, 3), (128, 28, 28, 240, 5),
         (128, 14, 14, 672, 5), (128, 7, 7, 1152, 5)]


def build_variants():
    source = (build.CSRC_DIR / "depthwise_conv.cu").read_text()
    if TAP not in source:
        raise RuntimeError("the tap line of depthwise_conv.cu has changed")
    out_dir = build.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    fns = {}
    for name, line in VARIANTS.items():
        src, lib = out_dir / f"dw_{name}.cu", out_dir / f"dw_{name}.so"
        src.write_text(source.replace(TAP, line))
        subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", str(lib), str(src)], check=True)
        fn = ctypes.CDLL(str(lib)).vince_depthwise_conv
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns, out_dir / "dw_exact.cu"


def sass_counts(src):
    """Opcode counts of dw_kernel<bf16, 5, 2>, the whole kernel."""
    cubin = str(src.with_suffix(".cubin"))
    flags = [f for f in build.NVCC_FLAGS if f not in ("-shared", "-Xcompiler", "-fPIC")]
    subprocess.run([build._nvcc(), *flags, "-cubin", "-o", cubin, str(src)], check=True)
    cuobjdump = os.path.join(os.path.dirname(build._nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", cubin], capture_output=True, text=True,
                          check=True).stdout
    body = re.search(r"Function : \S*9dw_kernelI13__nv_bfloat16Li5ELi2E.*?(?=Function :|\Z)",
                     sass, re.S).group(0)
    ops = re.findall(r"/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", body)
    return collections.Counter(op.split(".")[0] for op in ops)


def main():
    if not torch.cuda.is_available():
        sys.exit("no CUDA device")
    fns, exact_src = build_variants()
    stream = torch.cuda.current_stream().cuda_stream
    for n, h, w, c, k in SITES:
        x = torch.randn(n, h, w, c, device="cuda").bfloat16()
        wt = (torch.randn(k, k, 1, c, device="cuda") * 0.2).bfloat16()
        out, y = torch.empty_like(x), torch.empty_like(x)

        def run(name, vec, tcv, band):
            status = fns[name](x.data_ptr(), wt.data_ptr(), out.data_ptr(), n, h, w, c, k, 1,
                               vec, tcv, band, stream)
            if status != 0:
                raise RuntimeError(f"CUDA error {status}")

        tiling = k4._tiling(h, w, c, 2)
        times = {name: time_ms(lambda: run(name, *tiling), iters=10, warmup=2) for name in fns}
        times["Tensor.copy_"] = time_ms(lambda: y.copy_(x), iters=10, warmup=2)
        sweep = []
        for vec, tcv, band in itertools.product((1, 2), (4, 8, 16, 32, 64, 128),
                                                (4, 7, 14, 28, 56, 112)):
            if band <= h:
                sweep.append((time_ms(lambda: run("exact", vec, tcv, band), iters=5, warmup=1),
                              f"vec={vec} tcv={tcv} band={band}"))
        sweep.sort()
        print(f"x [{n},{h},{w},{c}] k={k}, tiling (vec, tcv, band) = {tiling}: "
              + ", ".join(f"{name} {t:.4f} ms" for name, t in times.items())
              + f"; sweep best {sweep[0][0]:.4f} ms ({sweep[0][1]}), worst {sweep[-1][0]:.4f} ms "
              f"({sweep[-1][1]})", flush=True)
    counts = sass_counts(exact_src)
    print(f"SASS of dw_kernel<bf16, k=5, 2 channels>: {sum(counts.values())} opcodes: "
          + ", ".join(f"{op} {n}" for op, n in counts.most_common(12)))


if __name__ == "__main__":
    main()
