"""K1 (the streamed queue log-sum-exp) timed on the card from the package of
any tree, with one-line variants of its source that show where its time goes.

    python3 vince_tpu_torch/tools/queue_lse_timers.py [--root DIR] [--no-variants] [--sass DIR]

It imports ``vince_tpu_torch`` from DIR (default: this checkout), which builds
K1 from DIR's ``csrc/queue_logsumexp.cu``, and takes the timers
(``chip_smoke.time_ms`` with one flush before each timed call and with four,
``chip_smoke.launch_ms`` for each launch's device time) and the library call
from this checkout's ``chip_smoke.py``. At B = 128, D = 128, τ = 0.07 and
K = 65536 (the train step's queue) and K = 262144 (a queue for which the JAX
solver turns K1 on by itself) it prints:

- the forward under both timers, each launch's time (partial and combine),
  the library call and the bound; for the earlier kernel (two CTAs an SM)
  also its launches when its chunking asks for 132, 264 or 528 CTAs;
- unless ``--no-variants``: the partial kernel of each variant, a copy of the
  source with a line or a few changed, built into DIR's ``_build/variants``
  (their results are wrong by design, but for ``logits by component``):
  ``as built``, ``no W product`` (the exp-weighted key sum left out), ``no
  logits product`` (the q·kᵀ product left out), ``no products`` (both: the
  loads, the online max and the exps); for the one-CTA-per-SM kernel also
  ``no q loads`` and ``no key loads in W`` (the same FMAs without those
  shared-memory loads), ``no max shuffles`` and ``logits by component`` (the
  logits loop ordered by component of D across the register tile). The
  registers and spills of each build are printed (``ptxas -v``);
- with ``--sass DIR``: the opcode counts of the partial kernel at D <= 128,
  whose SASS listing goes to DIR.

``VARIANTS`` holds the lines to replace for each version of the source that
the repo has had, so that the parent's kernel (for example the parent commit
unpacked by ``git archive`` into ``_archive/``) and this checkout's can be
compared in one call: run parent, change, change, parent. A measurement aid:
the port does not import it.
"""

import argparse
import collections
import contextlib
import ctypes
import os
import re
import subprocess
import sys

import torch

HERE = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, HERE)

import chip_smoke as cs  # noqa: E402

SHAPES = [(128, 65536, 128), (128, 262144, 128)]
TAU = 0.07
FLUSHES = (1, 4)
# variant -> one list of (old, new) edits for each version of the source (the
# first whose every old text appears once in a tree's source is applied):
# the earlier kernel (64 rows x 64 keys a CTA, two CTAs an SM), then the
# one-CTA-per-SM kernel
VARIANTS = {
    "as built": [[]],
    "no W product": [
        [("for (int c = 0; c < BN; ++c) {", "for (int c = 0; c < 0; ++c) {")],
        [("for (int n = 0; n < BN; ++n) {", "for (int n = 0; n < 0; ++n) {")]],
    "no logits product": [
        [("for (int d = 0; d < dend; d += 4) {", "for (int d = 0; d < 0; d += 4) {")],
        [("for (int d = 0; d < DP; d += 4) {", "for (int d = 0; d < 0; d += 4) {")]],
}
VARIANTS["no products"] = [a + b for a, b in zip(VARIANTS["no W product"],
                                                 VARIANTS["no logits product"])]
# the one-CTA-per-SM kernel only: its products without some of their
# shared-memory loads (the same FMAs on values already in registers)
VARIANTS["no q loads"] = [[(
    "const float4 qv = *reinterpret_cast<const float4*>(qrow + 16 * i * LD + d);",
    "const float4 qv = kv[i % 4];")]]
VARIANTS["no key loads in W"] = [[(
    "const float4 kv = *reinterpret_cast<const float4*>(kcol + n * LD + 64 * jj);",
    "const float4 kv = make_float4(pv[jj], pv[jj + 1], pv[jj + 2], pv[jj + 3]);")]]
VARIANTS["no max shuffles"] = [[(
    "tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, off));",
    "tmax = fmaxf(tmax, tmax * 0.5f);")]]
# the logits product in the other order: all rows' q loaded, then each
# component of D across the whole register tile
VARIANTS["logits by component"] = [[(
    """      for (int i = 0; i < RI; ++i) {
        const float4 qv = *reinterpret_cast<const float4*>(qrow + 16 * i * LD + d);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float a = fmaf(qv.x, kv[j].x, acc[i][j]);
          a = fmaf(qv.y, kv[j].y, a);
          a = fmaf(qv.z, kv[j].z, a);
          acc[i][j] = fmaf(qv.w, kv[j].w, a);
        }
      }""",
    """      for (int i = 0; i < RI; ++i) qv[i] = *reinterpret_cast<const float4*>(qrow + 16 * i * LD + d);
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(qv[i].x, kv[j].x, acc[i][j]);
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(qv[i].y, kv[j].y, acc[i][j]);
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(qv[i].z, kv[j].z, acc[i][j]);
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(qv[i].w, kv[j].w, acc[i][j]);"""),
    ("      float4 kv[4];\n", "      float4 kv[4], qv[RI];\n")]]


def build_variants(build):
    """Each variant that applies to the tree's source, built all at once:
    {name: (CDLL, the ptxas lines of its kernels)}."""
    source = (build.CSRC_DIR / "queue_logsumexp.cu").read_text()
    out_dir = build.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, versions in VARIANTS.items():
        edits = next((e for e in versions if all(source.count(old) == 1 for old, _ in e)), None)
        if edits is None:
            print(f"  variant '{name}': its lines are not in this source", flush=True)
            continue
        text = source
        for old, new in edits:
            text = text.replace(old, new)
        stem = "qlse_" + name.replace(" ", "_")
        src, lib = out_dir / f"{stem}.cu", out_dir / f"{stem}.so"
        src.write_text(text)
        cmd = [build._nvcc(), *build.NVCC_FLAGS, "-Xptxas", "-v", f"-I{build.CSRC_DIR}",
               "-o", str(lib), str(src)]
        procs[name] = lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT, text=True)
    built = {}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for '{name}':\n{log}")
        usage = [line.split("ptxas info    : ")[-1] for line in log.splitlines()
                 if "registers" in line or "spill" in line]
        built[name] = ctypes.CDLL(str(lib)), usage
    return built


@contextlib.contextmanager
def entry(k1, lib):
    """Launch K1 through the C entry of ``lib``: through ``_entry`` where the
    module has one, else through its ``build.load``."""
    if hasattr(k1, "_entry"):
        built = k1._entry()
        fn = getattr(lib, built.__name__)
        fn.argtypes, fn.restype = built.argtypes, built.restype
        saved, k1._entry = k1._entry, lambda: fn
        try:
            yield
        finally:
            k1._entry = saved
    else:
        saved = k1.build

        class Shim:
            load = staticmethod(lambda name: lib)
            check = staticmethod(saved.check)

        k1.build = Shim
        try:
            yield
        finally:
            k1.build = saved


def sass_counts(build, dump_dir):
    """Opcode counts of the partial kernel at D <= 128 as built; its listing
    goes to ``dump_dir``."""
    (build.BUILD_DIR / "variants").mkdir(parents=True, exist_ok=True)
    cubin = str(build.BUILD_DIR / "variants" / "qlse.cubin")
    flags = [f for f in build.NVCC_FLAGS if f not in ("-shared", "-Xcompiler", "-fPIC")]
    subprocess.run([build._nvcc(), *flags, "-cubin", "-o", cubin,
                    str(build.CSRC_DIR / "queue_logsumexp.cu")], check=True)
    cuobjdump = os.path.join(os.path.dirname(build._nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", cubin], capture_output=True, text=True,
                          check=True).stdout
    listing = re.search(r"Function : \S*qlse_partial_kernelILi8ELi2E.*?(?=Function :|\Z)",
                        sass, re.S).group(0)
    os.makedirs(dump_dir, exist_ok=True)
    with open(os.path.join(dump_dir, "sass_qlse_partial.txt"), "w") as f:
        f.write(listing)
    ops = re.findall(r"/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", listing)
    return collections.Counter(op.split(".")[0] for op in ops)


def split(fn):
    """``chip_smoke.launch_ms`` of ``fn`` with short kernel names."""
    try:
        t = cs.launch_ms(fn)
    except RuntimeError as err:
        print(f"  ({err})", flush=True)
        return {}
    return {re.sub(r"^qlse_|_kernel$", "", k): v for k, v in t.items()}


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--root", default=HERE, help="the tree whose vince_tpu_torch is timed")
    parser.add_argument("--no-variants", action="store_true", help="time the kernel as built only")
    parser.add_argument("--sass", metavar="DIR",
                        help="write the partial kernel's SASS (D <= 128) to DIR and print its "
                             "opcode counts")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    sys.path.insert(0, os.path.abspath(args.root))
    from vince_tpu_torch.device import full_f32_products
    from vince_tpu_torch.ops.kernels import build
    from vince_tpu_torch.ops.kernels import infonce_kernel as k1

    full_f32_products()
    dev = torch.device("cuda", 0)
    print(cs.gpu_name_and_power(), flush=True)
    print(f"package: {os.path.dirname(os.path.dirname(k1.__file__))}; ms, cold L2, "
          f"'x1'/'x4': flushes before each timed call", flush=True)
    if args.sass:
        counts = sass_counts(build, args.sass)
        print("SASS of the partial kernel at D <= 128: " + ", ".join(
            f"{op} {n}" for op, n in counts.most_common()), flush=True)
    variants = {} if args.no_variants else build_variants(build)
    for name, (_, usage) in variants.items():
        print(f"  ptxas, {name}: " + "; ".join(usage), flush=True)
    g = torch.Generator(device=dev).manual_seed(0)
    for b, k, d in SHAPES:
        q = torch.nn.functional.normalize(torch.randn(b, d, generator=g, device=dev), dim=-1)
        queue = torch.nn.functional.normalize(torch.randn(k, d, generator=g, device=dev), dim=-1)
        fwd = lambda: k1.queue_logsumexp_forward(q, queue, TAU)
        times = {f"kernel x{n}": cs.time_ms(fwd, flushes=n) for n in FLUSHES}

        def library():
            logits = q @ queue.T / TAU
            return torch.logsumexp(logits, -1), torch.softmax(logits, -1) @ queue

        times["library x4"] = cs.time_ms(library)
        bound_ms, _ = cs.bound(4 * (2 * b * d + k * d + 2 * b), 4 * b * k * d + b * k,
                               cs.F32_FLOPS)
        print(f"B={b} K={k} D={d}: " + ", ".join(f"{n} {t:.4f}" for n, t in times.items())
              + f", bound {bound_ms:.4f} (f32 operations)", flush=True)
        print("  launches: " + ", ".join(f"{n} {t:.4f}" for n, t in split(fwd).items()),
              flush=True)
        if hasattr(k1, "_TARGET_CTAS"):  # the earlier kernel: CTAs asked of its chunking
            saved = k1._TARGET_CTAS
            for target in (132, 264, 528):
                k1._TARGET_CTAS = target
                t = split(fwd)
                print(f"  chunking for {target} CTAs {k1._chunking(b, k)}: "
                      + ", ".join(f"{n} {v:.4f}" for n, v in t.items()), flush=True)
            k1._TARGET_CTAS = saved
        for name, (lib, _) in variants.items():
            with entry(k1, lib):
                t = split(fwd)
            print(f"  {name}: " + ", ".join(f"{n} {v:.4f}" for n, v in t.items()), flush=True)
        del q, queue


if __name__ == "__main__":
    main()
