"""The control of the comparison: the reference in fp8, put in the program's
place, is refused by the cell's limits, at a size a test run holds (on the
card the same at the cell's own size: ``python3 -m vince_bench.control``)."""

import pytest
import torch

from vince_bench import check, control, harness

import tiny


def _readings(device, name, canvas=None, **over):
    cfg = tiny.config(name, "bfloat16", **over)
    mix = dict(tiny.step_traffic(), **({"canvas": canvas} if canvas else {}))
    return control.readings(cfg, mix, 2**31 + 23, device, True)


@pytest.mark.parametrize("name, workload", [("vince-r18", "r18.step"),
                                            ("vince-r50-large", "r50-large.step")])
def test_the_control_fails(name, workload):
    rows = _readings(torch.device("cpu"), name)
    limits = harness.limits(workload)
    assert not check.verdict(rows["control_fp8"], limits), rows
    assert not check.verdict(rows["fault_half_batch"], limits), rows
    assert rows["control_fp8"]["keys"] > 3 * rows["program"]["keys"], rows


@pytest.mark.chip
def test_the_control_fails_on_the_card(cuda_device):
    rows = _readings(cuda_device, "vince-r18", canvas=256, batch_size=64, input_width=224,
                     input_height=224, vince_queue_size=65536)
    assert not check.verdict(rows["control_fp8"], harness.limits("r18.step")), rows
    assert rows["control_fp8"]["keys"] > 3 * rows["program"]["keys"], rows
