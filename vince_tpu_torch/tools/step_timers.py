"""The captured ResNet50 train step of the package of any tree, timed on the
card, so that two trees' steps can be compared in one call.

    python3 vince_tpu_torch/tools/step_timers.py [--root DIR] [--replays N]

It imports ``vince_tpu_torch`` from DIR (default: this checkout), which builds
its kernels from DIR's sources, and takes the configuration and the batches
of this checkout's ``chip_smoke.py`` phase 5 (ResNet50, b=128, 224²,
q=65536, bf16, fused InfoNCE, the fold kernel, one device). After the
warm-up calls and the capture it times N replays, each alone between two
CUDA events, and prints the median and the quartiles in ms with the card's
name and power limit. One tree per process: for a before/after, unpack the
parent into ``_archive/`` (which ``.gitignore`` lists) and run parent,
change, change, parent in one call. A measurement aid: the port does not
import it.
"""

import argparse
import os
import sys

import numpy as np
import torch

HERE = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, HERE)

import chip_smoke as cs  # noqa: E402


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--root", default=HERE, help="the tree whose vince_tpu_torch is timed")
    parser.add_argument("--replays", type=int, default=20)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    sys.path.insert(0, os.path.abspath(args.root))
    from vince_tpu_torch.solvers import vince_step as vs

    dev = torch.device("cuda", 0)
    cfg = cs.train_config("ResNet50")
    opt = vs.build_vince_optimizer(0.03)
    state = vs.init_vince_state(0, cfg, opt, device=dev)
    step = vs.make_train_step(cfg, opt)
    batches = [cs.make_batch(dev, seed=i) for i in range(2)]
    for i in range(vs.WARMUP_STEPS + 2):  # the warm-up calls, the capture, one replay
        step(state, batches[i % 2], i)
    times = []
    for i in range(args.replays):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        step(state, batches[i % 2], i)
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    q1, med, q3 = np.percentile(times, [25, 50, 75])
    print(f"{os.path.dirname(os.path.dirname(vs.__file__))}: captured ResNet50 step, "
          f"{args.replays} replays: median {med:.3f} ms (quartiles {q1:.3f}-{q3:.3f}); "
          f"{cs.gpu_name_and_power()}", flush=True)


if __name__ == "__main__":
    main()
