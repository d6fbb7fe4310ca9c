"""Run one cell of the benchmark once.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the repository's root.  The cell (``BENCHMARK.json``'s workloads)
names a configuration (``configs/<name>.json``: the statement family, its
size and protocol parameters) and a traffic mix (``traffic/<name>.json``,
read by :mod:`portbench.statements`), whose ``loop`` names the file that
drives the window (``loops/<loop>.py``).  Set-up builds and warms the
model; the loop proves statements for ``--seconds`` (the closed loop: back
to back, ending at the first prove that completes after that); then the
reference recomputes a sample of the window's proofs
(:mod:`portbench.check`, the statement family by the configuration's
``model``: ``reference/families/<model>.py``).  The last line of
standard output is the result; standard error carries the set-up's parts,
the card's clocks and power beside the window and, as its last lines, each
number compared with its limit.  With ``--trace 1`` the window runs under
``torch.profiler`` and the result carries the per-layer metrics
(``metrics/<name>.py``).
"""

from __future__ import annotations

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import gc  # noqa: E402
import functools  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

from portbench import load_file, loops  # noqa: E402

PKG = Path(__file__).resolve().parent
ROOT = PKG.parent
#: top-level module names no run may hold once its window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "stark_tpu")


def _cache_dirs(root: Path) -> None:
    """Every build and kernel cache inside the checkout, at fixed paths."""
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(root / "build" / "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(root / "build" / "triton"))


def load_cell(root: Path, workload: str):
    """(BENCHMARK.json, cell, configuration, traffic) of ``workload`` as
    BENCHMARK.json and the files it names hold them; the traffic checked
    against its loop."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; cells: {sorted(cells)}")
    cell = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    config = json.loads((root / configs[cell["config"]]["file"]).read_text())
    traffic = json.loads((root / "portbench" / "traffic" / f"{cell['traffic']}.json").read_text())
    loops.for_traffic(traffic)
    return bench, cell, config, traffic


def forbidden_modules():
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def nvidia_smi(index: int = 0):
    fields = "name,power.limit,power.draw,clocks.sm,clocks.max.sm,clocks.mem,temperature.gpu"
    try:
        out = subprocess.run(["nvidia-smi", "-i", str(index), f"--query-gpu={fields}", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=20)
    except (OSError, subprocess.SubprocessError):
        return None
    return dict(zip(fields.split(","), [v.strip() for v in out.stdout.strip().split(",")])) if out.stdout else None


def metric_reader(name: str):
    """``read(ctx)`` of the per-layer metric ``name``: ``metrics/<name>.py``,
    or for ``<family>_roofline`` with no file of its own the one reader of a
    family's share (``metrics/_roofline.py``) over ``roofline/<family>.py``."""
    path = PKG / "metrics" / f"{name}.py"
    family = name[: -len("_roofline")] if name.endswith("_roofline") else None
    if not path.is_file() and family and (PKG / "roofline" / f"{family}.py").is_file():
        return functools.partial(load_file(PKG / "metrics" / "_roofline.py", "portbench.metrics._roofline").read,
                                 family=family)
    return load_file(path, f"portbench.metrics.{name}").read


def cell_metrics(bench: dict, cell_name: str, kind: str):
    """The ``end_to_end`` or ``per_layer`` entries that this cell reports."""
    return [m for m in bench[kind] if "workloads" not in m or cell_name in m["workloads"]]


class Timed:
    """Set-up's parts, in seconds."""

    def __init__(self) -> None:
        self.parts = {}

    @contextlib.contextmanager
    def part(self, name: str):
        t0 = time.perf_counter()
        yield
        self.parts[name] = self.parts.get(name, 0.0) + time.perf_counter() - t0


def proofs_per_s(records, window_s: float) -> float:
    """Proofs completed over the window's seconds."""
    return sum(1 for r in records if r.proof is not None) / window_s


def _program_class(path: str):
    module, _, name = path.partition(":")
    return getattr(importlib.import_module(module), name)


def run(workload: str, seed: int, seconds: float, trace: bool, *, device: str = "cuda", root: Path = ROOT,
        require_chip: bool = True, config_overrides: dict = None, out=None, err=None) -> int:
    out = out or sys.stdout
    err = err or sys.stderr

    def say(*parts):
        print(*parts, file=err, flush=True)

    _cache_dirs(root)
    bench, cell, config, traffic = load_cell(root, workload)
    config = {**config, **(config_overrides or {})}
    loop = loops.load(traffic["loop"])
    import torch

    if require_chip:
        if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
            say(f"portbench: this cell needs {cell['chips']} CUDA card(s); "
                f"torch.cuda.is_available() = {torch.cuda.is_available()}, "
                f"device_count = {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
            return 2
    if str(root) not in sys.path:
        sys.path.insert(0, str(root))
    from .statements import Generator, check_indices, rng_seed

    dev = torch.device(device)
    on_card = dev.type == "cuda"
    say(f"portbench: cell {workload} seed {seed} seconds {seconds} trace {int(trace)}; "
        f"usable CPUs {len(os.sched_getaffinity(0))}")
    timed = Timed()

    # ---- set-up ---------------------------------------------------------
    with timed.part("cuda_init"):
        if on_card:
            torch.cuda.init()
            torch.zeros(1, device=dev)
            torch.cuda.synchronize(dev)
    with timed.part("libraries"):
        from stark_tpu_torch.field import FieldElement
        from stark_tpu_torch.ops import kernels
        from stark_tpu_torch.rng import DeterministicRandom
        from stark_tpu_torch.stark import Stark

        if on_card:
            kernels.library()
        try:
            from stark_tpu_torch.native import hashing_native  # the host C library

            hashing_native.batch_shake256_ctr(rng_seed(seed, 0), 0, 1, 17)
            host_library = "loaded; the rng's batch draw takes its native path"
        except (ImportError, ValueError) as exc:
            host_library = f"absent, the rng's batch draw falls back to hashlib ({exc})"
    cls = _program_class(config["program"])

    def build(size: int, stream: int):
        return cls(size, device=device, expansion_factor=config["expansion_factor"],
                   num_colinearity_tests=config["num_colinearity_tests"],
                   security_level=config["security_level"], rng=DeterministicRandom(rng_seed(seed, stream)))

    gen = Generator(config, traffic, seed)
    shared = traffic["model"] == "shared"
    with timed.part("model"):
        model = build(int(config["size"]), 0)
    if config.get("air_build"):
        with timed.part("air"):
            model.constraints  # noqa: B018  (the AIR, built once and kept by the model)
    if "precompile" in traffic["warm"]:
        with timed.part("precompile"):
            model.precompile()
    warm_proves = 0
    if "prove" in traffic["warm"]:
        with timed.part("warm_prove"):
            model.prove(*[FieldElement(v) for v in gen.warm_statement().inputs])
        warm_proves = 1
    if not shared:
        model = None
    if on_card:
        torch.cuda.synchronize(dev)
        setup_peak = torch.cuda.max_memory_allocated(dev)
    else:
        setup_peak = 0
    build_info = dict(kernels.build_info)
    say("portbench: set-up " + " ".join(f"{k}={v:.4f}" for k, v in timed.parts.items())
        + f"; kernel library {'cached' if build_info.get('cached') else 'built'}"
        f" ({build_info.get('seconds', 0.0):.2f} s of nvcc), host library {host_library}")
    smi_before = nvidia_smi() if on_card else None
    say(f"portbench: card before the window {smi_before}")

    # ---- the window -----------------------------------------------------
    stark_calls = []  # (wall s, last_profile totals) in a traced run
    counted = []  # (family, ops, bytes) of every kernel launch, traced run
    draw_counts = []  # the randomizer polynomial's coefficients of each traced prove
    patches = []
    if trace:
        from torch.autograd.profiler import record_function

        from . import roofline

        fam_of = {key: (name, mod) for name, mod in roofline.families().items() for key in mod.LAUNCHES}
        orig_launch = kernels.launch

        def launch(kernel, entry, *args, device, size):
            if kernel in fam_of:
                name, mod = fam_of[kernel]
                counted.append((name,) + tuple(mod.count(kernel, args, size)))
            return orig_launch(kernel, entry, *args, device=device, size=size)

        orig_prove = Stark.prove

        def stark_prove(self, *a, **k):
            with record_function("portbench.stark"):
                t0 = time.perf_counter()
                result = orig_prove(self, *a, **k)
                wall = time.perf_counter() - t0
            prof_ = self.last_profile
            stark_calls.append((wall, dict(prof_.totals) if prof_ is not None else {}))
            draw_counts.append(self.fri_domain_length // self.expansion_factor)
            return result

        kernels.launch = launch
        Stark.prove = stark_prove
        patches = [(kernels, "launch", orig_launch), (Stark, "prove", orig_prove)]
        span = record_function
        from stark_tpu_torch.ops.guard import count_plain_calls

        plain_calls = count_plain_calls(dev.type)
        activities = [torch.profiler.ProfilerActivity.CPU]
        if on_card:
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        profiler = torch.profiler.profile(activities=activities)
    else:
        span = lambda name: contextlib.nullcontext()  # noqa: E731
        profiler = contextlib.nullcontext()
        plain_calls = contextlib.nullcontext()

    def prove(st):
        nonlocal model
        if not shared:
            model = None
            model = build(st.size, st.index + 1)
        claim, proof = model.prove(*[FieldElement(v) for v in st.inputs])
        return claim.value, proof

    collections = []  # (generation, seconds) of the collector's runs in the window

    def on_gc(phase, info, _t=[0.0]):
        if phase == "start":
            _t[0] = time.perf_counter()
        else:
            collections.append((info["generation"], time.perf_counter() - _t[0]))

    kernels.reset_launch_counts()
    if on_card:
        torch.cuda.reset_peak_memory_stats(dev)
    setup_s = time.perf_counter() - _T0
    cpu_before = os.times()
    gc.callbacks.append(on_gc)
    try:
        with plain_calls as plain, profiler as prof, span("portbench.window"):
            records, window_s, failed = loop.drive(loops.Window(
                gen.statement, prove, seconds, span, say, traffic, config, build, model if shared else None))
    finally:
        gc.callbacks.remove(on_gc)
        for obj, name, orig in patches:
            setattr(obj, name, orig)
    cpu_after = os.times()
    if trace and on_card:
        say(f"portbench: plain field_ops calls on the card in the window: {sum(plain.values())} {dict(plain)}")
    completed = sum(1 for r in records if r.proof is not None)
    peak = torch.cuda.max_memory_allocated(dev) if on_card else 0
    launches = dict(kernels.LAUNCHES)
    smi_after = nvidia_smi() if on_card else None
    say(f"portbench: card after the window {smi_after}")
    say(f"portbench: window {window_s:.4f} s, {len(records)} proves, {completed} completed, {failed} failed, "
        f"{completed / window_s:.6f} proofs/s{' (traced)' if trace else ''}; prove ms "
        f"{[round(1e3 * r.seconds, 1) for r in records]}")
    gen2 = [t for g, t in collections if g == 2]
    say(f"portbench: in the window the collector ran {len(collections)} times, {sum(t for _, t in collections):.4f} s; "
        f"{len(gen2)} full collections, {sum(gen2):.4f} s; process CPU s user "
        f"{cpu_after.user - cpu_before.user:.3f} system {cpu_after.system - cpu_before.system:.3f}")

    # ---- metrics --------------------------------------------------------
    device_info = {"platform": "gpu" if on_card else dev.type,
                   "kind": torch.cuda.get_device_name(dev) if on_card else dev.type,
                   "count": int(cell["chips"]), "memory_peak_bytes": int(max(setup_peak, peak))}
    metrics = {}
    breakdown = None
    if not trace:
        e2e = {"proofs_per_s": proofs_per_s(records, window_s), "peak_device_mib": peak / 2**20, "setup_s": setup_s}
        for m in cell_metrics(bench, workload, "end_to_end"):
            if m["name"] in e2e and (on_card or m["name"] != "peak_device_mib"):
                metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}
    else:
        from . import roofline, tracing
        from .roofline import peaks as roofline_peaks

        t_read = time.perf_counter()
        dtrace = tracing.read(prof)
        say(f"portbench: the trace read in {time.perf_counter() - t_read:.2f} s")
        summary = None
        if dtrace is not None and on_card:
            pk = roofline_peaks.peaks(dev.index or 0)
            if pk is not None:
                summary = roofline.summarize(counted, dtrace.by_kernel, *pk)
                say(f"portbench: peaks {pk[0]:.6e} int32 op/s, {pk[1]:.6e} B/s")
                for name, s in summary.items():
                    say(f"portbench: roofline {name}: calls {s['calls']}, traced {s['traced']}, "
                        f"least {s['least_s']:.6e} s, kernels {s['kernel_s']:.6e} s, share {s['share_pct']} %")
                over = {n: s["share_pct"] for n, s in summary.items() if (s["share_pct"] or 0) > 100}
                if over:
                    say(f"portbench: a roofline share above 100 % is a counting error: {over}")
                    return 3
        if dtrace is not None:
            device_info["busy_s"] = dtrace.busy_s()
            device_info["window_s"] = dtrace.window_s
            breakdown = {"device_ops": dtrace.top_kernels(10), "idle_gaps": dtrace.idle_gaps(10)}
        draws = [p["randomizer_poly/draw"] for _, p in stark_calls if "randomizer_poly/draw" in p]
        if draws:
            t0 = time.perf_counter()
            os.urandom(17 * draw_counts[-1])
            say(f"portbench: randomizer_poly/draw {1e3 * sum(draws) / len(draws):.4f} ms a prove (seeded stream); "
                f"the same bytes from OS entropy {1e3 * (time.perf_counter() - t0):.4f} ms")
        ctx = {"proves": [r.seconds for r in records if r.proof is not None], "stark": stark_calls,
               "launches": launches, "trace": dtrace, "roofline": summary, "setup": timed.parts}
        for m in cell_metrics(bench, workload, "per_layer"):
            value = metric_reader(m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    # ---- correctness ----------------------------------------------------
    done = [(pos, r) for pos, r in enumerate(records) if r.proof is not None]
    model = None
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    picks = check_indices(seed, len(done), int(config["check_sample"]))
    from .check import LIMITS, compare, stream_position

    numbers = compare(config, traffic, seed, [done[k] for k in picks], warm_proves, failed, dev,
                      getattr(loop, "stream_position", stream_position))
    ref_s = time.perf_counter() - t_ref
    correct = all(numbers[k] <= LIMITS[k] for k in LIMITS)
    found = forbidden_modules()
    if found:
        say(f"portbench: the run holds modules it must not load: {found}")
        return 4
    checks = {k: {"value": numbers[k], "limit": LIMITS[k]} for k in LIMITS}
    result = {"correct": correct, "attempted": len(records), "failed": failed, "metrics": metrics,
              "device": device_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = checks
    say(f"portbench: reference recomputed proofs {[done[k][1].statement.index for k in picks]} in {ref_s:.2f} s")
    for k in LIMITS:
        say(f"check {k} = {numbers[k]} (limit {LIMITS[k]})")
    print(json.dumps(result), file=out, flush=True)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)
    return run(a.workload, a.seed, a.seconds, bool(a.trace))


if __name__ == "__main__":
    sys.exit(main())
