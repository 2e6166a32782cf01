"""The readings that set a cell's limits (``limits/<workload>.json``): over
each seed, the program's numbers (``check.py``) against the reference; on
the seeds given with ``--control``, also those of the control, the
reference in the next precision below the configuration's bfloat16 (fp8
e4m3 operands of every convolution and linear layer), and of one planted
fault, the reference with the loss taken over half of the batch. (A step
that leaves the state unchanged reads 1 on ``change`` by definition.)

The benchmark's runs do not run this. On the card, from the root of a
checkout:

    python3 -m vince_bench.control --workload r50-large.step --seeds 1,2,3 --control 1,2,3

prints one JSON line per seed and kind, then the largest of each number
over the program's seeds and the smallest over the control's and the
fault's.
"""

import argparse
import json
import sys
import time

import torch

from vince_bench import check, harness, traffic
from vince_bench.reference.layers import fp8_round

PLANTED = {"control_fp8": {"quant": fp8_round}, "fault_half_batch": {"half_batch": True}}


def readings(config: dict, mix: dict, seed: int, device, control: bool) -> dict:
    """{kind: numbers} of one seed: the program's, and with ``control``
    the control's and the fault's."""
    t0 = time.perf_counter()
    program, params0, queue0, feed, prog = harness.set_up(config, mix, seed, device)
    harness.free(program, device)
    del program
    t1 = time.perf_counter()
    ref = harness.reference(config, params0, queue0, feed, seed, device)
    out = {"program": dict(check.numbers(prog, ref), loss_steps=_loss_steps(prog, ref),
                           program_s=t1 - t0, reference_s=time.perf_counter() - t1)}
    if control:
        for kind, planted in PLANTED.items():
            t = time.perf_counter()
            side = harness.reference(config, params0, queue0, feed, seed, device, **planted)
            out[kind] = dict(check.numbers(side, ref), loss_steps=_loss_steps(side, ref),
                             seconds=time.perf_counter() - t)
    return out


def _loss_steps(side: dict, ref: dict) -> list:
    """Each compared step's relative loss gap, to show where ``loss`` comes from."""
    return [abs(a - b) / abs(b) for a, b in zip(side["losses"], ref["losses"])]


# how far above the lower reading a planted kind's smallest must lie to set
# the upper one: the control three times, a fault ten times
RATIO = {"control_fp8": 3.0, "fault_half_batch": 10.0}
# a step that leaves the state unchanged reads 1 on ``change`` (no run needed);
# it counts where that is three times the lower reading
UNCHANGED = {"change": 1.0}


def summary(rows) -> dict:
    """The lower reading of each number (the program's largest), each
    planted kind's smallest, and the limits they give: the upper reading is
    the least of the planted readings that lie far enough above the lower,
    and the limit lies two thirds of the way from the lower to the upper on
    a log scale, so that fresh seeds of the program have the more room. A
    number with no upper reading gets no limit."""
    out = {}
    for kind in ("program", *PLANTED):
        values = [r[kind] for r in rows if kind in r]
        if values:
            pick = max if kind == "program" else min
            out[kind] = {k: pick(v[k] for v in values) for k in check.NUMBERS}
    limits, readings = {}, {}
    for k in check.NUMBERS:
        lower = out["program"][k]
        uppers = {kind: out[kind][k] for kind in RATIO
                  if kind in out and out[kind][k] >= RATIO[kind] * lower}
        if k in UNCHANGED and UNCHANGED[k] >= 3.0 * lower:
            uppers["state_unchanged"] = UNCHANGED[k]
        readings[k] = {"lower": lower, "upper_candidates": uppers}
        if uppers:
            upper = min(uppers.values())
            limits[k] = lower ** (1 / 3) * upper ** (2 / 3)
    out["limits"], out["readings"] = limits, readings
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated")
    p.add_argument("--control", default="", help="the seeds that also run the control")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    bench = harness.benchmark()
    cell = harness.cell(bench, args.workload)
    config = harness.config_file(bench, cell["config"])
    mix = traffic.load(cell["traffic"])
    device = torch.device(args.device)
    control = {int(s) for s in args.control.split(",") if s}
    rows = []
    for seed in (int(s) for s in args.seeds.split(",")):
        row = readings(config, mix, seed, device, seed in control)
        rows.append(row)
        for kind, nums in row.items():
            print(json.dumps({"workload": args.workload, "seed": seed, "kind": kind, **nums}),
                  flush=True)
    print(json.dumps({"workload": args.workload, "summary": summary(rows)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
