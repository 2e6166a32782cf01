"""Other schedules and one-line variants of the fused 1×1 kernel (K2) and of
the fused 3×3 kernel (K3) on the card, against what the wrappers pick.

    python3 vince_tpu_torch/tools/fold_conv_sweeps.py      # from the repo's root

For each ResNet50 site shape at batch 128, 224² it prints each launch's
device time (``chip_smoke.launch_ms``: torch.profiler, cold L2):

- K2: the main kernel and the whole op (``chip_smoke.time_ms``) for every
  split of F over work items (``folded_dot_kernel.Plan.fsplit``) and the
  moments kernel for other numbers
  of row splits of each s2 tile, the plan's own marked; then the main kernel
  as built, ``no build`` (no y read, no x̂ built: what the W stream, the
  products and the stores take) and ``no products`` (no wgmma: what the
  builds, the W stream and the stores take);
- K3: the op's time (``chip_smoke.time_ms``) for every number of images side
  by side that ``conv_bn_kernel._tiles`` weighs, the tiling's own marked;
  then each launch of the op (the filter's cast, the main kernel, the
  reduce) as built, ``no halo`` (no halo built: the filter stream, the
  products and the epilogue) and ``no products``.

The variants are copies of the sources with one line changed, built into
``vince_tpu_torch/_build/variants`` (their results are wrong by design). A
measurement aid: the port does not import it.
"""

import collections
import contextlib
import ctypes
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from chip_smoke import (  # noqa: E402
    K2_SHAPES, K3_SHAPES, conv_bn_inputs, gpu_name_and_power, k2_inputs, launch_ms, time_ms)
from vince_tpu_torch.ops.kernels import build  # noqa: E402
from vince_tpu_torch.ops.kernels import conv_bn_kernel as k3  # noqa: E402
from vince_tpu_torch.ops.kernels import folded_dot_kernel as k2  # noqa: E402

# (source, variant) -> the text of the source it replaces, and by what
VARIANTS = {
    ("affine_relu_dot_moments", "no build"): [
        ("if (fc == 0 || nsc > 1) {", "if (false) {"),
        ("if (nsc == 1 && fc == fchunks - 1 && it_next < items) {", "if (false) {")],
    ("affine_relu_dot_moments", "no products"): [
        ("kk < BK / 16; ++kk)\n            wgmma_m64n128k16<0, 0>(",
         "kk < 0; ++kk)\n            wgmma_m64n128k16<0, 0>(")],
    ("affine_conv3x3_stats", "no halo"): [
        ("for (int g0 = wg; g0 < R / 8; g0 += 2 * HALO_BATCH) {",
         "for (int g0 = wg; g0 < 0; g0 += 2 * HALO_BATCH) {")],
    ("affine_conv3x3_stats", "no products"): [
        ("kk < BK / 16; ++kk) {\n          const uint64_t db",
         "kk < 0; ++kk) {\n          const uint64_t db")],
}
MODULES = {"affine_relu_dot_moments": k2, "affine_conv3x3_stats": k3}


def build_variants():
    """Every variant's C entry, built all at once; raises if a line it
    replaces is not in the source once."""
    out_dir = build.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for (name, variant), edits in VARIANTS.items():
        source = (build.CSRC_DIR / f"{name}.cu").read_text()
        for old, new in edits:
            if source.count(old) != 1:
                raise RuntimeError(f"{name}.cu: the line that '{variant}' replaces has changed")
            source = source.replace(old, new)
        stem = f"{name}_{variant.replace(' ', '_')}"
        src, lib = out_dir / f"{stem}.cu", out_dir / f"{stem}.so"
        src.write_text(source)
        cmd = [build._nvcc(), *build.NVCC_FLAGS, f"-I{build.CSRC_DIR}", "-o", str(lib), str(src)]
        procs[name, variant] = lib, subprocess.Popen(cmd)
    entries = {}
    for (name, variant), (lib, proc) in procs.items():
        if proc.wait() != 0:
            raise RuntimeError(f"nvcc failed for {name} '{variant}'")
        built = MODULES[name]._entry()
        fn = getattr(ctypes.CDLL(str(lib)), built.__name__)
        fn.argtypes, fn.restype = built.argtypes, built.restype
        entries[name, variant] = fn
    return entries


def split(fn):
    """``launch_ms`` of ``fn``, or NaN for every kernel where the trace lost
    launches (said on a line of its own)."""
    try:
        return launch_ms(fn)
    except RuntimeError as err:
        print(f"  ({err})", flush=True)
        return collections.defaultdict(lambda: float("nan"))


@contextlib.contextmanager
def entry(module, fn):
    """Launch ``module``'s kernel through the C entry ``fn``."""
    saved = module._entry
    module._entry = lambda: fn
    try:
        yield
    finally:
        module._entry = saved


def sweep_k2(dev, g, variants):
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for m, c, f in K2_SHAPES:
        y, a, b, w = k2_inputs(g, dev, m, c, f)
        chosen = k2.plan(m, c, f, sms)
        print(f"K2 M={m} C={c} F={f}: {chosen}", flush=True)
        chunks = f // 128
        for fs in [d for d in range(1, chunks + 1) if chunks % d == 0]:
            p = chosen._replace(fsplit=fs, grid=min(-(-m // 128) * fs, sms))
            t = split(lambda: k2._launch_with(y, a, b, w, p))["ardm_main_kernel"]
            t_op = time_ms(lambda: k2._launch_with(y, a, b, w, p))
            print(f"  main fsplit={fs:2d} grid={p.grid:3d}: {t:.4f} ms, the op {t_op:.4f} ms"
                  f"{'  <- plan' if fs == chosen.fsplit else ''}", flush=True)
        for msplit in sorted({chosen.msplit, max(1, chosen.msplit // 4),
                              max(1, chosen.msplit // 2), chosen.msplit * 2}):
            rows = -(-(-(-m // msplit)) // 64) * 64
            p = chosen._replace(msplit=-(-m // rows), rows=rows)
            t = split(lambda: k2._launch_with(y, a, b, w, p))
            print(f"  moments msplit={p.msplit:3d} rows={rows:5d}: "
                  f"{t['ardm_moments_kernel']:.4f} ms, reduce {t['ardm_reduce_kernel']:.4f} ms"
                  f"{'  <- plan' if p.msplit == chosen.msplit else ''}", flush=True)
        for variant in ("as built", "no build", "no products"):
            fn = variants.get(("affine_relu_dot_moments", variant), k2._entry())
            with entry(k2, fn):
                t = split(lambda: k2._launch_with(y, a, b, w, chosen))["ardm_main_kernel"]
            print(f"  main, {variant}: {t:.4f} ms", flush=True)


def sweep_k3(dev, g, variants):
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for n, h, w, c, f in K3_SHAPES:
        args = conv_bn_inputs(g, dev, n, h, w, c, f)
        chosen = k3._tiling(n, h, w, f, sms)
        print(f"K3 [{n},{h},{w},{c}] F={f}: {chosen}", flush=True)
        for _, tile in sorted(k3._tiles(n, h, w, f, sms), key=lambda kt: kt[1].images)[:8]:
            t = time_ms(lambda: k3._launch_with(*args, tile))
            print(f"  {tile}: {t:.4f} ms{'  <- tiling' if tile == chosen else ''}", flush=True)
        for variant in ("as built", "no halo", "no products"):
            fn = variants.get(("affine_conv3x3_stats", variant), k3._entry())
            with entry(k3, fn):
                t = split(lambda: k3._launch_with(*args, chosen))
            print(f"  {variant}: " + ", ".join(f"{k} {v:.4f}" for k, v in t.items()) + " ms",
                  flush=True)


def main():
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    dev = torch.device("cuda", 0)
    print(gpu_name_and_power(), flush=True)
    variants = build_variants()
    g = torch.Generator(device=dev).manual_seed(0)
    sweep_k2(dev, g, variants)
    sweep_k3(dev, g, variants)


if __name__ == "__main__":
    main()
