"""The reference's step against the port's eager step on the CPU, at a tiny
size, in float32: the same weights, queue, frames and seed give the same
losses, gradients, changes and keys to float32's rounding. (At 32² the last
stage's BatchNorm normalises 8 values a channel, which magnifies the
rounding of the first updates: a leaf's change agrees to about 1%, where a
fault reads 0.3 to 1.)"""

import pytest
import torch

from vince_bench import check, harness, traffic
from vince_bench.reference import step as ref_step

import tiny

CPU = torch.device("cpu")


@pytest.mark.parametrize("name", ["vince-r50-large", "vince-r18"])
def test_reference_follows_the_port(name):
    cfg = tiny.config(name)
    program, params0, queue0, feed, prog = harness.set_up(cfg, tiny.step_traffic(), 2**31 + 9,
                                                          CPU)
    harness.free(program, CPU)
    ref = harness.reference(cfg, params0, queue0, feed, 2**31 + 9, CPU)
    nums = check.numbers(prog, ref)
    assert nums["loss"] < 1e-4 and nums["grad"] < 1e-4, nums
    assert nums["change"] < 2e-2 and nums["keys"] < 1e-4, nums
    assert len(ref["losses"]) == harness.COMPARED_STEPS
    assert ref["keys"].shape == (harness.COMPARED_STEPS * cfg["batch_size"],
                                 cfg["vince_embedding_size"])


def test_reference_remat_changes_nothing():
    cfg = tiny.config("vince-r50-large")
    params0, queue0 = harness.start_values(cfg, 3, CPU)
    feed = traffic.StepFeed(tiny.step_traffic(), cfg["batch_size"], 3, CPU)
    plain = harness.reference(cfg, params0, queue0, feed, 3, CPU)
    remat = ref_step.follow(ref_step.StepConfig.from_config(cfg), harness.reference_model(cfg),
                            params0, queue0, [feed.frames(i) for i in range(2)], 3, remat=True)
    assert remat["losses"] == pytest.approx(plain["losses"][:2], rel=1e-6)


def test_gaps_are_nan_when_the_program_is():
    ref = {"losses": [1.0, 1.0], "grad": {"a": 1.0, "b": 0.0}, "grad_max": {"a": 1.0, "b": 1.0},
           "change": {"a": 1.0, "b": 1.0, "key.a": 1.0, "key.b": 1.0},
           "keys": torch.ones(2, 2)}
    prog = dict(ref, losses=[1.0, float("nan")], keys=torch.full((2, 2), float("nan")))
    nums = check.numbers(prog, ref)
    assert nums["loss"] != nums["loss"] and nums["keys"] != nums["keys"]
    assert nums["grad"] == 0.0 and not check.verdict(nums, {"loss": 1.0, "grad": 1.0})
