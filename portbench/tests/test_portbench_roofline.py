"""The roofline's counts on hand-worked shapes."""

import pytest

from portbench import roofline

F = roofline.families()


def test_every_family_names_kernels_and_launches():
    assert set(F) == {"ntt", "merkle", "fold", "fs", "fieldvec", "combination", "digits"}
    keys = [k for m in F.values() for k in m.LAUNCHES]
    assert len(keys) == len(set(keys))


def test_an_ntt_of_2_20_points():
    # four-step plan R = C = 2^10: pass 1 holds 2^10 column transforms of
    # 2^10 points (2^9 * 10 butterflies each) and the 2^20 twiddles W, pass
    # 2 the 2^10 row transforms; a coset scales once more an element
    p1 = F["ntt"].count("ntt_pass1", [0, 0, 10, 10, 0, 0, 0, 0], 1 << 20)
    p2 = F["ntt"].count("ntt_pass2", [0, 0, 10, 10, 0, 0, 0], 1 << 20)
    butterflies = (1 << 19) * 20
    assert p1[0] + p2[0] == (butterflies + (1 << 20)) * 16
    assert p1[1] == p2[1] == 2 * (1 << 20) * 16
    coset = F["ntt"].count("ntt_pass1", [0, 0, 10, 10, 0, 0, 123, 456], 1 << 20)
    assert coset[0] - p1[0] == (1 << 20) * 16


def test_a_tree_of_2_20_leaves():
    # the prove's split: leaves, K5 down to 2^19, the subtrees kernel down to
    # 512, the top kernel to the root: 2^21 - 1 compressions in all
    n = 1 << 20
    parts = [F["merkle"].count("merkle_leaves", [0, 0, n], n),
             F["merkle"].count("merkle_level", [0, 0, n], n),
             F["merkle"].count("merkle_subtrees", [0, 0, n >> 1, 10], n >> 1),
             F["merkle"].count("merkle_top", [0, 0, 512], 512)]
    assert sum(p[0] for p in parts) == (2 * n - 1) * 12 * 8 * 22
    assert parts[0][1] == n * (16 + 32)


def test_shares_from_counted_calls():
    s = roofline.summarize([("fold", 3e9, 0.0), ("fold", 0.0, 3.35e9)],
                           {"fold_kernel": [0.5, 0.5], "leaf_kernel": [1.0]}, 3e9, 3.35e9)
    assert s["fold"]["least_s"] == pytest.approx(2.0)
    assert s["fold"]["share_pct"] == pytest.approx(200.0)
    assert s["merkle"]["calls"] == 0 and s["merkle"]["least_s"] == 0.0


def test_the_int32_peak_is_64_lanes_an_sm(monkeypatch):
    import types

    import torch

    from portbench.roofline import peaks

    props = types.SimpleNamespace(name="NVIDIA H100 80GB HBM3", multi_processor_count=132)
    monkeypatch.setattr(torch.cuda, "get_device_properties", lambda i: props)
    monkeypatch.setattr(peaks, "max_sm_clock_hz", lambda i: 1.98e9)
    ops, nbytes = peaks.peaks(0)
    assert ops == pytest.approx(132 * 64 * 1.98e9) and nbytes == 3.35e12
