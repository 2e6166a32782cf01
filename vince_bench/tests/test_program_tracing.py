"""The program's tracing on the card (``vince_tpu_torch/utils/tracing.py``),
ResNet18 at 64 frames of 224², queue 65536: a step captured with tracing off
holds no event-record node and one captured with it on six; the five regions
sum to within 3% of the replay's own time, timed from outside; the two
graphs' replays take the same time; a call of the captured step leaves its
four spans in a profiler session, and set-up its spans and counters."""

import re
import statistics

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from vince_bench import port, traffic

import tiny

SEED = 2**31 + 41
ROUNDS, REPLAYS = 3, 8


def _program(device, on: bool, tmp_path):
    """A captured step built and captured with tracing on or off, its graph
    kept for ``debug_dump``; (program, its feed, the graph's event-record
    nodes)."""
    from vince_tpu_torch.solvers.vince_step import WARMUP_STEPS
    from vince_tpu_torch.utils import tracing

    graph_class = torch.cuda.CUDAGraph

    def debug_graph():
        # the graph's nodes kept after the capture, for ``debug_dump``
        graph = graph_class(keep_graph=True)
        graph.enable_debug_mode()
        return graph

    cfg = tiny.config("vince-r18", "bfloat16", batch_size=64, input_width=224,
                      input_height=224, vince_queue_size=65536)
    (tracing.enable if on else tracing.disable)()
    mp = pytest.MonkeyPatch()
    mp.setattr(torch.cuda, "CUDAGraph", debug_graph)
    try:
        program = port.Program(cfg, device)
        feed = traffic.StepFeed(dict(traffic.load("step"), canvas=256), cfg["batch_size"],
                                SEED, device)
        for i in range(WARMUP_STEPS + 1):
            program.metrics_to_host(program.step(feed.batch(i), SEED))
    finally:
        mp.undo()
    dot = tmp_path / f"graph_{int(on)}.dot"
    program.step_fn.graph.debug_dump(str(dot))
    nodes = [line for line in dot.read_text().splitlines()
             if "->" not in line and re.search(r"event[ _]?record", line, flags=re.IGNORECASE)]
    return program, feed, len(nodes)


def _replays(program, n: int):
    """``n`` replays, each between two events of the stream: their times and
    the regions read after each."""
    from vince_tpu_torch.utils import tracing

    step, times, regions = program.step_fn, [], []
    for _ in range(n):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        step.graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
        step.marks.arm()
        tracing.read_regions()
        if tracing.enabled():
            regions.append(tracing.records()["regions"][-1])
    return times, regions


@pytest.mark.chip
def test_regions_sum_to_the_replay_and_cost_nothing_off(cuda_device, tmp_path):
    from vince_tpu_torch.solvers.vince_step import STEP_REGIONS, WARMUP_STEPS
    from vince_tpu_torch.utils import tracing

    tracing.reset()
    try:
        off, _, off_nodes = _program(cuda_device, False, tmp_path)
        on, feed, on_nodes = _program(cuda_device, True, tmp_path)
        assert (off_nodes, on_nodes) == (0, len(STEP_REGIONS) + 1)
        rec = tracing.records()
        assert len(rec["spans"]["vince.step.warmup"]) == WARMUP_STEPS
        assert len(rec["spans"]["vince.step.capture"]) == 1
        assert len(rec["spans"]["vince.setup.init_state"]) == 1
        for name in ("reserved_after_warmup", "allocated_after_warmup", "reserved_after_capture",
                     "allocated_after_capture"):
            assert len(rec["counters"][name]) == 1 and rec["counters"][name][0] > 0, name
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            on.metrics_to_host(on.step(feed.batch(0), SEED))
        names = {e.name for e in prof.events() if e.name.startswith("vince.")}
        assert names == {"vince.step.draws", "vince.step.inputs", "vince.step.replay",
                         "vince.step.outputs"}, names
        t_off, t_on, sums = [], [], []
        for _ in range(ROUNDS):
            tracing.disable()
            t_off += _replays(off, REPLAYS)[0]
            tracing.enable()
            times, regions = _replays(on, REPLAYS)
            t_on += times
            for t, r in zip(times, regions):
                assert set(r) == set(STEP_REGIONS) and min(r.values()) > 0, r
                sums.append(sum(r.values()) / t)
        print(f"event-record nodes off {off_nodes}, on {on_nodes}; replay ms off "
              f"{statistics.median(t_off):.3f}, on {statistics.median(t_on):.3f}; regions "
              f"over the replay {min(sums):.4f}-{max(sums):.4f}; last "
              f"{ {k: round(v, 3) for k, v in regions[-1].items()} }")
        assert all(0.97 <= s <= 1.03 for s in sums), sums
        assert abs(statistics.median(t_on) / statistics.median(t_off) - 1) < 0.03
    finally:
        tracing.disable()
        tracing.reset()
