"""The harness's own arithmetic and loaders, on the CPU."""

import ast
import contextlib
import io
import json
import shutil
from pathlib import Path

import pytest

from portbench import load_file, loops as L, run as R, statements as S, tracing as T
from portbench.check import byte_distance

ROOT = Path(__file__).resolve().parents[2]
PKG = ROOT / "portbench"


def _config(name):
    return json.loads((PKG / "configs" / f"{name}.json").read_text())


def _traffic(name="warm-queue"):
    return json.loads((PKG / "traffic" / f"{name}.json").read_text())


@pytest.mark.parametrize("config", ["fibonacci", "rescue-chain"])
def test_statements_repeat_from_a_seed_and_differ_across_seeds(config):
    c, t = _config(config), _traffic()
    a = [S.Generator(c, t, 2**31 + 11).statement(i) for i in range(5)]
    b = [S.Generator(c, t, 2**31 + 11).statement(i) for i in range(5)]
    other = [S.Generator(c, t, 2**31 + 12).statement(i) for i in range(5)]
    assert a == b
    assert all(x.inputs != y.inputs for x, y in zip(a, other))
    assert len({s.inputs for s in a}) == 5
    assert all(len(s.inputs) == c["inputs"] and s.size == c["size"] for s in a)
    assert S.Generator(c, t, 7).warm_statement().inputs not in {s.inputs for s in a}
    assert S.rng_seed(7, 0) == S.rng_seed(7, 0) != S.rng_seed(8, 0)


def test_sizes_of_a_mix_are_a_seeded_order_of_one_set():
    t = {**_traffic(), "model": "per_request", "sizes": {"low": 32759, "high": 65526, "count": 256}}
    c = _config("fibonacci")
    one = [S.Generator(c, t, 5).statement(i).size for i in range(256)]
    two = [S.Generator(c, t, 6).statement(i).size for i in range(256)]
    assert sorted(one) == sorted(two) and one != two
    assert min(one) == 32759 and max(one) == 65526 and len(set(one)) == 256


class _Clock:
    def __init__(self, proves):
        self.t, self.proves = 0.0, list(proves)

    def __call__(self):
        return self.t


def _closed(prove, clock):
    w = L.Window(lambda i: i, prove, 10.0, lambda n: contextlib.nullcontext(), lambda *a: None,
                 _traffic(), {}, clock=clock)
    return L.load("closed").drive(w)


def test_the_window_ends_at_the_first_prove_completing_after_its_seconds():
    clock = _Clock([])
    durations = iter([1.5] * 100)

    def prove(st):
        clock.t += next(durations)
        return 1, b"p"

    records, window_s, failed = _closed(prove, clock)
    assert len(records) == 7 and window_s == 10.5 and failed == 0  # 6 proves end at 9.0 s, the 7th at 10.5 s
    assert R.proofs_per_s(records, window_s) == pytest.approx(7 / 10.5)


def test_a_failed_prove_counts_as_attempted_not_completed():
    clock = _Clock([])

    def prove(st):
        clock.t += 4.0
        if st == 1:
            raise RuntimeError("boom")
        return 1, b"p"

    records, window_s, failed = _closed(prove, clock)
    assert (len(records), failed, window_s) == (3, 1, 12.0)
    assert R.proofs_per_s(records, window_s) == pytest.approx(2 / 12.0)


def test_percentile_is_over_every_prove():
    p95 = load_file(PKG / "metrics" / "prove_ms.p95.py", "prove_ms_p95").p95
    assert p95(list(range(1, 101))) == 95
    assert p95([3.0, 1.0, 2.0]) == 3.0
    assert p95(list(range(20))) == 18  # nearest rank: the 19th of 20
    assert R.metric_reader("prove_ms.p95")({"proves": [0.001 * k for k in range(1, 101)]}) == pytest.approx(95.0)


def test_idle_intervals_union_and_gaps():
    busy = T.union([(1, 3), (2, 4), (6, 7), (6.5, 6.8), (-1, 0.5), (9, 12)], 0, 10)
    assert busy == [(0, 0.5), (1, 4), (6, 7), (9, 10)]
    assert T.gaps_of(busy, 0, 10) == [(0.5, 1), (4, 6), (7, 9)]


def _events():
    us = 1e6

    def ev(cat, name, ts, dur):
        return {"ph": "X", "cat": cat, "name": name, "ts": ts * us, "dur": dur * us}

    return [
        ev("user_annotation", "portbench.window", 10, 10),
        ev("user_annotation", "portbench.prove#0", 10, 5),
        ev("user_annotation", "portbench.stark", 11, 3),
        ev("user_annotation", "portbench.prove#1", 15, 5),
        ev("kernel", "void (anonymous namespace)::ntt_pass_kernel<true, 3>(int const*, int*)", 12, 1),
        ev("kernel", "void stark::leaf_kernel<true>(int const*, unsigned int*, long)", 12.5, 1),
        ev("gpu_memcpy", "Memcpy DtoH", 16, 0.5),
        ev("kernel", "ntt_pass_kernel<false, 3>(int const*, int*)", 5, 1),  # before the window
    ]


def test_trace_reading_busy_idle_and_labels():
    t = T.parse(_events())
    assert t.window == (10, 20) and t.window_s == 10
    assert [k[0] for k in t.kernels] == ["ntt_pass_kernel", "stark::leaf_kernel"]
    assert sorted(t.by_kernel) == ["leaf_kernel", "ntt_pass_kernel"]
    assert t.busy_s() == pytest.approx(2.0)
    assert t.kernel_s() == pytest.approx(2.0)
    assert [(n, round(s, 6)) for n, s in t.idle_gaps()] == [
        ("prove#1 outside Stark.prove", 3.5),  # 16.5 .. 20
        ("prove#0 outside Stark.prove", 2.5),  # 13.5 .. 16, its midpoint past Stark.prove
        ("prove#0 in Stark.prove", 2.0),  # 10 .. 12
    ]
    assert t.label(12.2) == "prove#0 in Stark.prove"
    assert T.kernel_base("void at::native::vectorized_elementwise_kernel<4, X>(int, X)") == \
        "at::native::vectorized_elementwise_kernel"
    assert T.kernel_base("void at::native::(anonymous namespace)::reduce_kernel<512, 1>(R<float>)") == \
        "at::native::reduce_kernel"


def test_byte_distance():
    assert byte_distance(b"abc", b"abc") == 0
    assert byte_distance(b"abc", b"abd") == 1
    assert byte_distance(b"abc", b"ab") == 1


def test_every_metric_file_matches_its_entry():
    """Each per-layer metric has a reader: its own file, or a family's
    share read by the one reader over roofline/<family>.py; every reader
    file and every family has its metric."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    names = {m["name"] for m in bench["per_layer"]}
    assert names >= {p.stem for p in (PKG / "metrics").glob("*.py")} - {"_roofline"}
    from portbench import roofline

    assert names >= {f"{f}_roofline" for f in roofline.families()}
    ctx = {"roofline": {"fold": {"least_s": 1.0, "kernel_s": 4.0}}}
    assert R.metric_reader("fold_roofline")(ctx) == pytest.approx(25.0)
    assert R.metric_reader("ntt_roofline")(ctx) is None
    for m in bench["per_layer"]:
        assert callable(R.metric_reader(m["name"]))
    with pytest.raises(FileNotFoundError):
        R.metric_reader("no_such_roofline")
    from portbench.reference.prover import make_prover

    for c in bench["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"] and cfg["reduced"] == c["reduced"]
        ref = make_prover(cfg["model"], cfg["size"], cfg["expansion_factor"], cfg["num_colinearity_tests"], "cpu")
        assert ref.fri_length == cfg["fri_domain_length"] == 2 ** 20
    for w in bench["workloads"]:
        L.for_traffic(_traffic(w["traffic"]))


def test_a_cell_of_new_files_only_loads(tmp_path):
    """A later cell (fib-cold-stmt-2e19) as new files under configs/ and
    traffic/ and new entries in BENCHMARK.json: no existing file edited."""
    root = tmp_path / "checkout"
    shutil.copytree(PKG, root / "portbench", ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    before = {p: p.read_bytes() for p in (root / "portbench").rglob("*") if p.is_file()}
    (root / "portbench" / "traffic" / "cold-stmt.json").write_text(json.dumps({
        "why": "a new model a statement, steps from 256 values over [32759, 65526]", "loop": "closed",
        "clients": 1, "model": "per_request", "sizes": {"low": 32759, "high": 65526, "count": 256},
        "warm": ["precompile"]}))
    bench["workloads"].append({"name": "fib-cold-stmt-2e19", "config": "fibonacci", "traffic": "cold-stmt",
                               "chips": 1, "why": "every request misses the model cache"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    _, cell, config, traffic = R.load_cell(root, "fib-cold-stmt-2e19")
    gen = S.Generator(config, traffic, 99)
    sizes = {gen.statement(i).size for i in range(256)}
    assert len(sizes) == 256
    # every size's FRI domain: 4 x the power of two above twice its randomized trace
    assert {4 * (1 << (2 * (s + 1 + 8)).bit_length()) for s in sizes} == {2 ** 19}
    assert all(p.read_bytes() == b for p, b in before.items())


GATED_CLIENTS = '''"""Several closed-loop callers behind one gate, as a service serves them."""
import threading

from portbench.loops import Record

KEYS = {"clients"}


def drive(w):
    gate, lock = threading.Lock(), threading.Lock()
    records, issued, end = [], [0], [None]
    t_start = w.clock()

    def client():
        while True:
            with lock:
                if end[0] is not None:
                    return
                i = issued[0]
                issued[0] += 1
            st = w.statement(i)
            with gate:
                if end[0] is not None:
                    return
                t0 = w.clock()
                claim, proof = w.prove(st)
                t1 = w.clock()
                records.append(Record(st, t1 - t0, claim, proof))
                if t1 - t_start >= w.seconds:
                    end[0] = t1

    threads = [threading.Thread(target=client) for _ in range(w.traffic["clients"])]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    w.say(f"gated-clients: {len(threads)} clients, {issued[0]} statements drawn")
    return records, end[0] - t_start, 0
'''


def test_a_mix_with_a_loop_and_a_family_of_its_own_runs_from_new_files_only(tmp_path):
    """A later cell whose traffic needs a loop of its own (several callers
    behind one gate) and whose configuration names a statement family of
    its own: new files under loops/, traffic/, configs/ and
    reference/families/ and a new entry in BENCHMARK.json, no existing
    file edited; the whole run, from that checkout, is correct."""
    import subprocess
    import sys

    root = tmp_path / "checkout"
    shutil.copytree(PKG, root / "portbench", ignore=shutil.ignore_patterns("__pycache__"))
    pb = root / "portbench"
    before = {p: p.read_bytes() for p in pb.rglob("*") if p.is_file()}
    (pb / "loops" / "gated-clients.py").write_text(GATED_CLIENTS)
    (pb / "traffic" / "service-stub.json").write_text(json.dumps({
        "why": "4 callers behind one gate", "loop": "gated-clients", "clients": 4, "model": "shared",
        "sizes": None, "warm": ["prove"]}))
    fam = (pb / "reference" / "families" / "fibonacci.py").read_text()
    (pb / "reference" / "families" / "fib-small.py").write_text(fam)
    config = {**_config("fibonacci"), "name": "fib-small", "model": "fib-small", "size": 1000,
              "check_sample": 3}
    (pb / "configs" / "fib-small.json").write_text(json.dumps(config))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "fib-small", "source": "stub", "file": "portbench/configs/fib-small.json",
                             "reduced": [], "why": "stub"})
    bench["workloads"].append({"name": "fib-service-stub", "config": "fib-small", "traffic": "service-stub",
                               "chips": 1, "why": "several callers through one gate"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    code = ("import sys; sys.path.insert(0, %r); sys.path.append(%r)  # the program from this repository\n"
            "from portbench import run\n"
            "assert run.PKG == run.ROOT / 'portbench' and str(run.ROOT) == %r\n"
            "sys.exit(run.run('fib-service-stub', 2**31 + 3, 1.0, False, device='cpu', require_chip=False))\n"
            ) % (str(root), str(ROOT), str(root))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=600, cwd=root)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] is True and result["attempted"] >= 1
    assert result["checks"]["proof_bytes_differing"]["value"] == 0
    assert "gated-clients: 4 clients" in out.stderr
    assert all(p.read_bytes() == b for p, b in before.items())


def test_the_run_refuses_a_machine_without_a_card(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out, err = io.StringIO(), io.StringIO()
    assert R.run("fib-warm-2e16", 1, 1.0, False, out=out, err=err) != 0
    assert out.getvalue() == "" and "CUDA" in err.getvalue()


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", None) == "import_module" and node.args \
                and isinstance(node.args[0], ast.Constant):
            yield node.args[0].value.split(".")[0]


def test_no_file_imports_jax_or_the_jax_package_and_the_reference_nothing_of_the_port():
    for path in PKG.rglob("*.py"):
        names = set(_imports(path))
        assert not names & {"jax", "jaxlib", "flax", "stark_tpu"}, (path, names)
        if "reference" in path.parts:
            assert "stark_tpu_torch" not in names, path
    for path in (PKG / "configs").glob("*.json"):
        prog = json.loads(path.read_text())["program"].split(".")[0]
        assert prog == "stark_tpu_torch"


def test_a_dry_run_of_the_loaders_loads_no_jax():
    import subprocess
    import sys

    code = ("import sys; sys.path.insert(0, %r)\n"
            "from portbench import run, roofline, statements, check, control, tracing, loops\n"
            "from portbench.reference import prover\n"
            "bench, cell, config, traffic = run.load_cell(run.ROOT, 'chain-warm-4096')\n"
            "run._program_class(config['program'])\n"
            "prover.family(config['model'])\n"
            "[run.metric_reader(m['name']) for m in bench['per_layer']]\n"
            "roofline.families()\n"
            "print(run.forbidden_modules())\n") % str(ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
