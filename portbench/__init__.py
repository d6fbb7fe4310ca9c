"""The benchmark of stark_tpu_torch: one cell (a configuration under a
traffic mix) a run, everything found by name under this folder.  Run it as
``python3 -m portbench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` from the repository's root."""

import importlib.util
from pathlib import Path
from types import ModuleType


def load_file(path: Path, name: str) -> ModuleType:
    """The module in ``path``, loaded under ``name``: how the harness finds
    a loop, a metric's reader, a roofline family or a reference family by
    the name ``BENCHMARK.json`` or a configuration gives it."""
    if not path.is_file():
        raise FileNotFoundError(f"{path} (looked up as {name!r})")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
