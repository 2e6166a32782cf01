"""A run of the harness on the CPU, past its look for a card, with the timed
path broken underneath: each fault a one-chip training cell can have turns
``correct`` false under the cell's limits, and the run without one stays
true. (The exchange between chips is no fault of a one-chip cell.)"""

import time

import pytest
import torch

from vince_bench import harness

import tiny

CPU = torch.device("cpu")


def _run(workload="r18.step", name="vince-r18"):
    out = harness.runner("step").run(tiny.config(name), tiny.step_traffic(), 2**31 + 17, 0.3,
                                     False, CPU, harness.limits(workload), time.perf_counter())
    return out


def _unchanged(monkeypatch):
    from vince_tpu_torch.solvers import vince_step

    # no update, no EMA, no enqueue: the step hands its state back as it was
    monkeypatch.setattr(vince_step.VinceOptimizer, "step", lambda self: None)
    monkeypatch.setattr(vince_step, "ema_update", lambda *a, **k: None)
    monkeypatch.setattr(vince_step, "enqueue_sharded", lambda state, *a, **k: state)


def _half_batch(monkeypatch):
    from vince_tpu_torch.solvers import vince_step

    full = vince_step.sharded_multi_pair_infonce

    def half(q, k, pos, temperature, *args, batch_neg_mask=None, **kw):
        rows = q.shape[0] // 2
        neg = None if batch_neg_mask is None else batch_neg_mask[:rows]
        return full(q[:rows], k, pos[:rows], temperature, *args, batch_neg_mask=neg, **kw)

    monkeypatch.setattr(vince_step, "sharded_multi_pair_infonce", half)


def _altered_key(monkeypatch):
    from vince_tpu_torch.solvers import vince_step

    enqueue = vince_step.enqueue_sharded

    def altered(state, items, *args, **kw):
        items = items.clone()
        items[0] = -items[0]
        return enqueue(state, items, *args, **kw)

    monkeypatch.setattr(vince_step, "enqueue_sharded", altered)


def test_a_sound_run_is_correct():
    out = _run()
    assert out.correct, out.compared
    assert out.attempted >= 1 and out.failed == 0


@pytest.mark.parametrize("fault, number", [(_unchanged, "change"), (_half_batch, "grad"),
                                           (_altered_key, "keys")])
def test_a_fault_is_not_correct(monkeypatch, fault, number):
    fault(monkeypatch)
    out = _run()
    assert not out.correct
    assert out.compared[number]["value"] > out.compared[number]["limit"], out.compared


def test_the_fault_on_the_bottleneck_cell(monkeypatch):
    _half_batch(monkeypatch)
    assert not _run("r50-large.step", "vince-r50-large").correct
