"""A cell's configuration cut to a size the CPU runs in seconds: 8 frames
(2 videos) of 32², a queue of 64; the published widths stay elsewhere."""

from vince_bench import harness, traffic

TINY = dict(batch_size=8, input_width=32, input_height=32, vince_queue_size=64)


def config(name: str, dtype: str = "float32", **over) -> dict:
    bench = harness.benchmark()
    c = dict(harness.config_file(bench, name), **TINY, compute_dtype=dtype)
    c.update(over)
    return c


def step_traffic() -> dict:
    return dict(traffic.load("step"), canvas=40)
