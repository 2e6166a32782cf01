"""K2's and K3's forwards timed under both cold-L2 timers, from the package of
any tree, so that two trees' kernels can be compared under one timer.

    python3 vince_tpu_torch/tools/fold_conv_timers.py [--root DIR]

It imports ``vince_tpu_torch`` from DIR (default: this checkout), which builds
its kernels from DIR's sources, and takes the inputs, the timer
(``chip_smoke.time_ms`` with one flush before each timed call, and with four)
and the library calls from this checkout's ``chip_smoke.py``. For each K2
site shape of a ResNet50 forward and each K3 shape, at batch 128, 224², it
prints the forward (K2 with W handed over as [C, F] contiguous and as the
model hands it, the transposed view of the 1×1 conv weight) and the library
call, each under both timers; then K2's sums over the 13 sites and K3's over
its three shapes. A measurement aid: the port does not import it.
"""

import argparse
import os
import sys

import torch

HERE = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, HERE)

import chip_smoke as cs  # noqa: E402

FLUSHES = (1, 4)


def row(label, fns, total=None, weight=1):
    """Times of each named function under both timers, printed on one line."""
    times = {f"{name} x{n}": cs.time_ms(fn, flushes=n) for name, fn in fns for n in FLUSHES}
    print(f"  {label}: " + ", ".join(f"{k} {v:.4f}" for k, v in times.items()), flush=True)
    if total is not None:
        for k, v in times.items():
            total[k] = total.get(k, 0.0) + weight * v


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--root", default=HERE, help="the tree whose vince_tpu_torch is timed")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    sys.path.insert(0, os.path.abspath(args.root))
    from vince_tpu_torch.ops.kernels import conv_bn_kernel as k3
    from vince_tpu_torch.ops.kernels import folded_dot_kernel as k2

    dev = torch.device("cuda", 0)
    print(cs.gpu_name_and_power(), flush=True)
    print(f"package: {os.path.dirname(os.path.dirname(k2.__file__))}; ms, cold L2, "
          f"'x1'/'x4': flushes before each timed call", flush=True)
    g = torch.Generator(device=dev).manual_seed(1)
    total = {}
    for (m, c, f), sites in zip(cs.K2_SHAPES, cs.K2_SITES):
        y, a, b, w = cs.k2_inputs(g, dev, m, c, f)
        wc, wb = w.contiguous(), w.bfloat16()
        row(f"K2 M={m} C={c} F={f} (x{sites})", [
            ("kernel W[C,F]", lambda: k2.affine_relu_dot_moments_forward(y, a, b, wc)),
            ("kernel W^T view", lambda: k2.affine_relu_dot_moments_forward(y, a, b, w)),
            ("library", lambda: cs.k2_library(y, a, b, wb))], total, sites)
        del y, w, wc, wb
    print("K2 per forward (13 sites): " + ", ".join(f"{k} {v:.4f}" for k, v in total.items()))
    total = {}
    for n, h, w, c, f in cs.K3_SHAPES:
        y_prev, a, b, kernel = cs.conv_bn_inputs(g, dev, n, h, w, c, f)
        wl = cs.k3_weight(kernel)
        row(f"K3 [{n},{h},{w},{c}] F={f}", [
            ("kernel", lambda: k3.affine_conv3x3_stats_forward(y_prev, a, b, kernel)),
            ("library", lambda: cs.k3_library(y_prev, a, b, wl))], total)
    print("K3 over its three shapes: " + ", ".join(f"{k} {v:.4f}" for k, v in total.items()))


if __name__ == "__main__":
    main()
