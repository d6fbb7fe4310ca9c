"""The readers of what the program keeps of itself while traced
(portbench/program_trace.py), on hand-made ranges, counters and traces."""

import pytest

from portbench import program_trace as P, run as R, tracing as T
from portbench.tests.test_portbench_harness import _events
from stark_tpu_torch.models.rescue_chain import RescueChainStark
from stark_tpu_torch.utils import profiling

READERS = ["entry.trace_ms", "host.gc_ms_per_prove", "host.gc_full_per_prove", "device.idle_unlabelled_pct",
           "setup.air_periodic_s"]


def _program(shift0=-1000.0, shift1=-1000.002):
    """The program's ranges of the two proves of _events(), each prove on a
    clock of its own offset from the trace's: the entry spans, a trace build
    with a full collection inside it, a protocol region."""
    return [
        ("stark.entry.trace", 10 + shift0, 10.8 + shift0),
        ("stark.protocol.combination", 11 + shift0, 12.5 + shift0),
        ("stark.entry.prove#0", 10 + shift0, 15 + shift0),
        ("stark.gc.gen2", 16.5 + shift1, 17.5 + shift1),
        ("stark.entry.trace", 15 + shift1, 18.5 + shift1),
        ("stark.entry.prove#1", 15 + shift1, 19 + shift1),
    ]


@pytest.fixture
def traced_program(monkeypatch):
    """The program's state after a traced window of two proves."""
    monkeypatch.setattr(profiling, "RANGES", _program())
    collector = profiling.Collector()
    collector.counts, collector.seconds = [40, 6, 3], [0.02, 0.03, 0.25]
    monkeypatch.setattr(profiling, "COLLECTOR", collector)
    air = profiling.Timer("air")
    air.totals.update(periodic=12.5, square_cube=3.0, assemble=50.0)
    monkeypatch.setattr(RescueChainStark, "air_profile", air)


def test_program_ranges_go_onto_the_trace_clock_prove_by_prove(traced_program):
    t = T.parse(_events())
    moved = dict((n, (round(a, 9), round(b, 9))) for n, a, b in P.on_trace_clock(t, P.ranges()))
    assert moved["stark.entry.prove#0"] == (10, 15) and moved["stark.entry.prove#1"] == (15, 19)
    assert moved["stark.gc.gen2"] == (16.5, 17.5)
    assert P.on_trace_clock(t, P.ranges()[:-1]) is None  # a prove the trace does not have


def test_program_readers_on_a_hand_made_window(traced_program):
    """Idle 10 .. 12, 13.5 .. 16 and 16.5 .. 20 (8 s); the program's ranges
    cover all of it but 19 .. 20: 1 s of 8 unnamed."""
    t = T.parse(_events())
    assert t.window_s - t.busy_s() == pytest.approx(8.0)
    ctx = {"trace": t, "proves": [4.0, 4.0]}
    assert R.metric_reader("device.idle_unlabelled_pct")(ctx) == pytest.approx(12.5)
    assert R.metric_reader("entry.trace_ms")(ctx) == pytest.approx(1e3 * (0.8 + 3.5 - 1) / 2)  # less the collection
    assert R.metric_reader("host.gc_ms_per_prove")(ctx) == pytest.approx(150.0)
    assert R.metric_reader("host.gc_full_per_prove")(ctx) == pytest.approx(1.5)
    assert R.metric_reader("setup.air_periodic_s")(ctx) == 12.5


@pytest.mark.parametrize("program", ["without the tracer", "traced nothing"])
@pytest.mark.parametrize("name", READERS)
def test_program_readers_read_nothing_where_the_program_kept_nothing(monkeypatch, name, program):
    """A tree from before the tracer (no ranges, counter or AIR profile), or
    one whose window traced no prove: no number, no exception."""
    if program == "without the tracer":
        monkeypatch.delattr(profiling, "RANGES")
        monkeypatch.delattr(profiling, "COLLECTOR")
        monkeypatch.delattr(RescueChainStark, "air_profile")
    else:
        monkeypatch.setattr(profiling, "RANGES", [])
        monkeypatch.setattr(profiling, "COLLECTOR", profiling.Collector())
        monkeypatch.setattr(RescueChainStark, "air_profile", profiling.Timer("air"))
    ctx = {"trace": T.parse(_events()), "proves": [4.0, 4.0], "stark": [(3.0, {}), (3.0, {})], "launches": {},
           "roofline": None, "setup": {"air": 60.0}}
    assert R.metric_reader(name)(ctx) is None
