"""The port's tracing (``vince_tpu_torch/utils/tracing.py``) on the CPU: off,
a step leaves no ``vince.*`` range in a profiler session and nothing kept;
on, the step's and set-up's spans are in the session with their host
seconds; timed regions are a no-op off the GPU; the kernels' build counts
only what ``nvcc`` compiled. The regions on the card:
``vince_bench/tests/test_program_tracing.py`` (``-m chip``)."""

import os

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from vince_tpu_torch.ops.kernels import build
from vince_tpu_torch.solvers import vince_step as vs
from vince_tpu_torch.utils import tracing

SETUP = ("vince.setup.init_state", "vince.setup.init_weights", "vince.setup.to_device",
         "vince.setup.init_queue")


@pytest.fixture(autouse=True)
def tracing_off():
    tracing.disable()
    tracing.reset()
    yield
    tracing.disable()
    tracing.reset()


def _cfg():
    src = vs.SourceSpec("YT", batch_size=4, num_frames=2, source_id=1)
    return vs.VinceConfig(sources=(src,), backbone="ResNet18", embed_size=16, image_size=32,
                          queue_size=32)


def _batch():
    g = torch.Generator().manual_seed(3)
    frames = [torch.randint(0, 256, (4, 40, 40, 3), dtype=torch.uint8, generator=g)
              for _ in range(2)]
    return ({"data": frames[0], "queue_data": frames[1]},)


def _traced_step():
    """A profiler session around a state's set-up and one eager step: the
    session's ``vince.*`` event names and the step's metrics."""
    cfg = _cfg()
    opt = vs.build_vince_optimizer(0.03)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        state = vs.init_vince_state(0, cfg, opt, device="cpu")
        _, metrics = vs.make_train_step_fn(cfg, opt)(state, _batch(), 5)
    names = {e.name for e in prof.events() if e.name.startswith("vince.")}
    return names, {k: float(v) for k, v in metrics.items()}


def test_off_a_step_leaves_no_span_and_keeps_nothing():
    names, _ = _traced_step()
    assert names == set()
    assert tracing.records() == {"spans": {}, "counters": {}, "regions": []}
    assert tracing.span("vince.a") is tracing.span("vince.b")  # the shared no-op
    assert tracing.regions(vs.STEP_REGIONS, "cpu") is tracing.NO_REGIONS
    tracing.count("c", 1)
    assert tracing.records()["counters"] == {}


def test_on_the_step_and_setup_spans_are_in_the_session_with_host_seconds():
    _, off = _traced_step()
    tracing.enable()
    names, on = _traced_step()
    assert {"vince.step.draws", "vince.step.body", *SETUP} <= names
    spans = tracing.records()["spans"]
    for name in ("vince.step.draws", "vince.step.body", *SETUP):
        assert len(spans[name]) == 1 and spans[name][0] > 0, (name, spans)
    children = sum(spans[n][0] for n in SETUP[1:])
    assert children <= spans["vince.setup.init_state"][0]
    assert on == off  # the spans change no number of the step
    assert tracing.records()["regions"] == []  # no timed region on the CPU


def test_regions_are_a_no_op_on_the_cpu():
    tracing.enable()
    marks = tracing.regions(vs.STEP_REGIONS, torch.device("cpu"))
    assert marks is tracing.NO_REGIONS
    for _ in range(len(vs.STEP_REGIONS) + 1):
        marks.mark()
    marks.arm()
    tracing.read_regions()
    assert tracing.records()["regions"] == []


class _FakeEvent:
    """A timing event whose clock moves 1 ms a record."""

    clock = 0.0

    def __init__(self, **kwargs):
        assert kwargs == {"enable_timing": True, "external": True}
        self.at = None

    def record(self):
        _FakeEvent.clock += 1.0
        self.at = _FakeEvent.clock

    def synchronize(self):
        pass

    def elapsed_time(self, end):
        return end.at - self.at


def test_regions_wait_until_read_and_are_read_once_a_set(monkeypatch):
    monkeypatch.setattr(torch.cuda, "Event", _FakeEvent)
    tracing.enable()
    marks = tracing.Regions(("a", "b"))
    marks.mark()
    marks.mark()
    tracing.read_regions()
    assert tracing.records()["regions"] == []  # the set's last boundary has not passed
    _FakeEvent.clock += 5.0
    marks.mark()
    marks.arm()  # a replay before the read: the set waits once
    tracing.read_regions()
    assert tracing.records()["regions"] == [{"a": 1.0, "b": 6.0}]
    tracing.read_regions()
    assert len(tracing.records()["regions"]) == 1
    marks.arm()  # the next replay of a graph that holds the marks
    tracing.read_regions()
    assert len(tracing.records()["regions"]) == 2
    tracing.disable()
    marks.arm()
    tracing.enable()
    tracing.read_regions()
    assert len(tracing.records()["regions"]) == 2


def test_count_and_reset():
    tracing.enable()
    tracing.count("reserved_after_warmup", 3)
    tracing.count("reserved_after_warmup", 4)
    with tracing.span("vince.x"):
        pass
    rec = tracing.records()
    assert rec["counters"] == {"reserved_after_warmup": [3, 4]}
    assert list(rec["spans"]) == ["vince.x"]
    rec["counters"]["reserved_after_warmup"].append(5)  # a copy
    assert tracing.records()["counters"]["reserved_after_warmup"] == [3, 4]
    tracing.reset()
    assert tracing.records() == {"spans": {}, "counters": {}, "regions": []}
    assert tracing.enabled()


@pytest.fixture
def stand_in_build(tmp_path, monkeypatch):
    """``build`` with its target in ``tmp_path``, no library cached, and
    ``ctypes.CDLL`` a stand-in."""
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(build, "_target", lambda name: tmp_path / f"{name}.so")
    monkeypatch.setattr(build, "_LIBS", {})
    monkeypatch.setattr(build.ctypes, "CDLL", lambda path: ("library", path))
    return tmp_path


def test_load_of_a_source_found_built_counts_no_build(stand_in_build):
    (stand_in_build / "k.so").write_bytes(b"")
    tracing.enable()
    assert build.load("k") == ("library", str(stand_in_build / "k.so"))
    build.load("k")  # cached: no second load
    rec = tracing.records()
    assert "kernels_built" not in rec["counters"]
    assert len(rec["spans"]["vince.kernels.load"]) == 1


def test_load_of_a_source_not_built_counts_its_build(stand_in_build, monkeypatch):
    class Nvcc:
        def __init__(self, cmd, **kwargs):
            self.out = cmd[cmd.index("-o") + 1]
            self.returncode = 0

        def communicate(self):
            open(self.out, "wb").close()
            return "", None

    monkeypatch.setattr(build, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(build.subprocess, "Popen", Nvcc)
    tracing.enable()
    build.load("k")
    built = tracing.records()["counters"]["kernels_built"]
    assert [name for name, _ in built] == ["k"] and built[0][1] >= 0
    assert os.path.exists(stand_in_build / "k.so")
