"""The comparison that decides ``correct`` fails what it must: the control
(the reference with a guarantee broken, in the program's place) and a run
whose timed path is broken underneath.  A run here is the harness's whole
run on the CPU (the card's check skipped) at a size the CPU holds."""

import io
import json
from pathlib import Path

import pytest

from portbench import control, run as R
from portbench.check import LIMITS

ROOT = Path(__file__).resolve().parents[2]


@pytest.mark.parametrize("workload,size", [("fib-warm-2e16", 1000), ("chain-warm-4096", 4)])
def test_each_control_comes_out_not_correct(workload, size):
    _, cell, config, traffic = R.load_cell(ROOT, workload)
    got = control.readings(config, traffic, 2**31 + 5, "cpu", completed=3, size=size)
    for kind in control.CONTROLS:
        assert got[kind]["proof_bytes_differing"] > LIMITS["proof_bytes_differing"], kind


def _run(size=1000, seconds=1.0):
    out, err = io.StringIO(), io.StringIO()
    rc = R.run("fib-warm-2e16", 2**31 + 77, seconds, False, device="cpu", require_chip=False,
               config_overrides={"size": size}, out=out, err=err)
    assert rc == 0, err.getvalue()[-3000:]
    line = out.getvalue().strip().splitlines()[-1]
    return json.loads(line), err.getvalue()


def test_a_sound_run_is_correct_and_its_line_has_the_keys():
    result, err = _run()
    assert result["correct"] is True
    assert list(result) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert set(result["metrics"]) == {"proofs_per_s", "setup_s"}  # no peak memory on the CPU
    assert err.strip().splitlines()[-1].startswith("check ")


def _patch_prove(monkeypatch, wrap):
    from stark_tpu_torch.models.fibonacci import FibonacciStark

    monkeypatch.setattr(FibonacciStark, "prove", wrap(FibonacciStark.prove))


def test_a_prove_that_returns_its_last_answer_is_not_correct(monkeypatch):
    def wrap(prove):
        kept = {}

        def stale(self, a, b):
            if "answer" not in kept:
                kept["answer"] = prove(self, a, b)
            return kept["answer"]

        return stale

    _patch_prove(monkeypatch, wrap)
    result, _ = _run()
    assert result["correct"] is False
    assert result["checks"]["proof_bytes_differing"]["value"] > 0


def test_a_proof_altered_where_it_is_produced_is_not_correct(monkeypatch):
    def wrap(prove):
        def altered(self, a, b):
            claim, proof = prove(self, a, b)
            return claim, proof[:-1] + bytes([proof[-1] ^ 1])

        return altered

    _patch_prove(monkeypatch, wrap)
    result, _ = _run()
    assert result["correct"] is False
    assert result["checks"]["proof_bytes_differing"]["value"] >= 1  # one byte in each proof checked


def test_a_combination_over_half_of_its_points_is_not_correct(monkeypatch):
    from stark_tpu_torch.stark import Stark

    orig = Stark._combination_device

    def half(self, *a, **k):
        cw = orig(self, *a, **k)
        n = cw.mont.shape[1]
        cw.mont[:, n // 2:] = 0
        return cw

    monkeypatch.setattr(Stark, "_combination_device", half)
    result, _ = _run()
    assert result["correct"] is False
