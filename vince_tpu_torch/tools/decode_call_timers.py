"""Host time of one ``--native-decode`` call on the card, for the package under
``--root`` (this tree by default): ``vince_tpu_torch.native.DecodePool.decode``
from JPEG bytes to the canvases in pinned host memory, as a loader thread
calls it.

    python3 vince_tpu_torch/tools/decode_call_timers.py [--root DIR]

For each path's shape per call (one ImageNet image of 500x375; an R2V2
item's 5 frames of 480x360; a batch of 160 such frames), all to a 256
canvas, it prints one JSON line: the median and the quartiles of the host's
time per call (the call returns after the decoder's stream is synchronised)
over ``--calls`` calls after a warm-up (``call_ms``), the same of nvJPEG's
decode alone to the end of the stream (``planes_ms``: ``decode_planes``, then
a synchronise), and the card's name and power limit.
One tree per process; for a before/after, unpack the parent commit into
``_archive/`` (``git archive``) and run parent, change, change, parent in one
call. A measurement aid: the port does not import it.
"""

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

SHAPES = {"ImageNet image": ((375, 500), 1), "R2V2 item": ((360, 480), 5),
          "160 frames": ((360, 480), 160)}
CANVAS = 256


def jpegs(hw, n, seed):
    """``n`` smooth RGB images of ``hw`` from the seed, encoded at cv2's
    default quality (4:2:0)."""
    import cv2

    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        small = rng.randint(0, 256, (hw[0] // 12, hw[1] // 12, 3), np.uint8)
        img = cv2.resize(small, hw[::-1], interpolation=cv2.INTER_CUBIC)
        img = np.clip(img.astype(np.int16) + rng.randint(-12, 13, img.shape), 0, 255)
        out.append(cv2.imencode(".jpg", img.astype(np.uint8))[1].tobytes())
    return out


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--root", default=HERE, help="the repository whose package is timed")
    parser.add_argument("--calls", type=int, default=200, help="timed calls a shape (a tenth "
                        "for the batch of 160)")
    args = parser.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch

    from vince_tpu_torch import native
    from vince_tpu_torch.ops.kernels import build

    assert os.path.dirname(native.__file__).startswith(root), native.__file__
    build.build_all(["jpeg_decode"])
    pool = native.DecodePool(torch.device("cuda", 0))
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=30).stdout.strip().splitlines()[0]
    result = {"root": os.path.relpath(root, HERE), "card": card}
    for what, (hw, n) in SHAPES.items():
        items = jpegs(hw, n, seed=n)
        calls = max(args.calls // 10, 5) if n > 8 else args.calls
        for _ in range(5):
            outs, ok = pool.decode(items, CANVAS)
        assert ok.all() and outs.shape == (n, CANVAS, CANVAS, 3)
        decoder = pool._decoder

        def planes_only():
            decoder.decode_planes(items)
            decoder.stream.synchronize()

        result[what] = {"calls": calls}
        for name, fn in (("call", lambda: pool.decode(items, CANVAS)), ("planes", planes_only)):
            ms = []
            for _ in range(calls):
                t0 = time.perf_counter()
                fn()
                ms.append((time.perf_counter() - t0) * 1e3)
            q = np.percentile(ms, [25, 50, 75])
            result[what].update({f"{name}_ms": float(q[1]), f"{name}_q25_ms": float(q[0]),
                                 f"{name}_q75_ms": float(q[2])})
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
