"""The port's tracer (``stark_tpu_torch.utils.profiling``) on the CPU: off,
a prove enters no profiler range and hooks nothing; under ``traced()``, or
in a prove that starts while a ``torch.profiler`` trace records, the
prove's regions and spans, and the collector's full runs, are ranges of
the running trace; ``reset()`` also zeroes ``PACKED_ROW_TRACES``."""

import gc
import json

import pytest
import torch

from stark_tpu_torch.field import FieldElement
from stark_tpu_torch.models.fibonacci import FibonacciStark
from stark_tpu_torch.models.rescue_chain import RescueChainStark, _native_rescue
from stark_tpu_torch.rng import DeterministicRandom
from stark_tpu_torch.utils import profiling


@pytest.fixture(scope="module")
def model():
    """Fib-60 through the device pipeline on CPU tensors (its floor
    lowered, as in test_torch_combination), warmed by one prove."""
    m = FibonacciStark(60, device="cpu", rng=DeterministicRandom(3))
    m.stark.backend.device_prover_min = 512
    assert m.stark._use_device_pipeline()
    m.prove(FieldElement(2), FieldElement(9))
    return m


def _ranges(prof, tmp_path):
    """(name, start, end) of every ``stark.*`` range of the exported trace."""
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())
    events = events["traceEvents"] if isinstance(events, dict) else events
    return sorted(((e["name"], e["ts"], e["ts"] + e["dur"]) for e in events
                   if e.get("ph") == "X" and e.get("name", "").startswith("stark.")),
                  key=lambda r: (r[1], -r[2]))


def _inside(r, s):
    return r is not s and s[1] <= r[1] and r[2] <= s[2]


def _profile():
    return torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])


def test_untraced_prove_enters_no_range_and_hooks_nothing(model, monkeypatch):
    """With no profiler recording and nothing traced, a prove opens no
    range and installs no hook."""
    def refused(*a, **k):
        raise AssertionError("entered while off")

    monkeypatch.setattr(profiling, "record_function", refused)
    monkeypatch.setattr(profiling, "_on", refused)
    before = list(gc.callbacks)
    model.prove(FieldElement(4), FieldElement(5))
    assert gc.callbacks == before
    assert profiling.span("stark.entry.trace") is profiling.prove_span()  # the one shared no-op


def test_a_prove_under_a_running_profiler_traces_itself(model, tmp_path):
    """A profiler window alone traces its proves: their ranges are in the
    trace and in RANGES, which the window's first prove resets, and the
    collector's hook is there only during each prove."""
    model.prove(FieldElement(1), FieldElement(2))  # a prove with no profiler: the next one starts a window
    profiling.RANGES.append(("stale", 0.0, 0.0))
    before = list(gc.callbacks)
    with _profile() as prof:
        model.prove(FieldElement(4), FieldElement(5))
        assert gc.callbacks == before
        model.prove(FieldElement(6), FieldElement(7))
    names = [n for n, _, _ in _ranges(prof, tmp_path)]
    entry = [n for n in names if n.startswith("stark.entry.prove#")]
    assert len(entry) == 2
    assert [n for n, _, _ in profiling.RANGES if n.startswith("stark.entry.prove#")] == entry
    assert sorted(n for n, _, _ in profiling.RANGES) == sorted(names)  # "stale" gone
    assert gc.callbacks == before


def test_traced_prove_nests_the_protocol_ranges_in_the_entry_prove(model, tmp_path):
    with _profile() as prof, profiling.traced():
        model.prove(FieldElement(6), FieldElement(7))
    ranges = _ranges(prof, tmp_path)
    entry = [r for r in ranges if r[0].startswith("stark.entry.prove#")]
    assert len(entry) == 1
    inside = [r for r in ranges if r is not entry[0]]
    assert all(_inside(r, entry[0]) for r in inside)
    assert [n for n, _, _ in inside if n.startswith("stark.entry.")] == ["stark.entry.trace"]
    protocol = [r for r in inside if r[0].startswith("stark.protocol.")]
    top = {r[0] for r in protocol if not any(_inside(r, s) for s in protocol)}
    totals = model.stark.last_profile.totals
    assert top == {f"stark.protocol.{k}" for k in totals if "/" not in k}
    assert {n for n, _, _ in protocol} == {f"stark.protocol.{k}" for k in totals}
    assert "stark.protocol.fri/query" in {n for n, _, _ in protocol}


def test_a_full_collection_under_traced_is_one_range_and_one_count(tmp_path):
    profiling.COLLECTOR.reset()
    gc.disable()  # no collection but the one this test asks for
    try:
        with _profile() as prof, profiling.traced() as collector:
            gc.collect(2)
    finally:
        gc.enable()
    assert collector is profiling.COLLECTOR
    assert [n for n, _, _ in _ranges(prof, tmp_path)] == ["stark.gc.gen2"]
    assert collector.counts == [0, 0, 1] and collector.seconds[2] > 0
    collector.reset()
    assert collector.counts == [0, 0, 0] and collector.seconds == [0.0, 0.0, 0.0]


def test_traced_restores_the_callbacks_on_exit_and_on_an_exception():
    before = list(gc.callbacks)
    with profiling.traced():
        assert gc.callbacks == before + [profiling.COLLECTOR]
        assert profiling.span("x") is not profiling.span("y")
    assert gc.callbacks == before
    with pytest.raises(RuntimeError, match="inside"):
        with profiling.traced():
            raise RuntimeError("inside")
    assert gc.callbacks == before
    assert profiling.span("x") is profiling.span("y")


def test_reset_zeroes_the_packed_row_trace_count(monkeypatch):
    """The count of device proves handed rows (test_torch_prover and
    test_torch_models count them) starts again from 0 where tracing does."""
    monkeypatch.setattr(profiling, "PACKED_ROW_TRACES", 3)
    profiling.reset()
    assert profiling.PACKED_ROW_TRACES == 0


def test_the_chain_air_build_and_witness_record_their_parts(tmp_path):
    chain = RescueChainStark(4, device=None)
    chain.constraints  # noqa: B018  (built once, into air_profile)
    assert set(chain.air_profile.totals) == {"periodic", "square_cube", "assemble"}
    with _profile() as prof, profiling.traced():
        chain.prove(FieldElement(3))
    names = [n for n, _, _ in _ranges(prof, tmp_path)]
    witness = ["stark.entry.trace/witness"] if _native_rescue() is not None else []
    assert [n for n in names if n.startswith("stark.entry.")][1:] == ["stark.entry.trace"] + witness
