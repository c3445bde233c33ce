"""What every run shares: the spec in BENCHMARK.json, the files found by
name (configurations, traffic mixes, drivers, metric readers, layer
counts, limits), the card checks, and the result line.

A cell `<config>.<traffic>` names `configs/<config>.json` (and its
`configs/<config>.py`, which makes the inputs) and `traffic/<traffic>.json`,
whose "driver" key names `drivers/<driver>.py`.  A per-layer metric
`<base>.<suffix>` is read by `metrics/<base>.<suffix>.py` or, failing
that, `metrics/<base>.py`; a layer's work count is `rooflines/<layer>.py`;
a cell's limits are `checks/<cell>.json`.  Nothing here imports torch, so
the spec and the files can be checked without a card.
"""
from __future__ import annotations

import importlib.util
import json
import re
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
SPEC_FILE = ROOT / "BENCHMARK.json"
# top-level module names that may not be loaded by a run of the port
FORBIDDEN = ("jax", "jaxlib", "flax", "ibgs_tpu")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


class SpecError(ValueError):
    """BENCHMARK.json, or a file it names, is missing or malformed."""


def load_spec(path: Path = SPEC_FILE) -> dict:
    if not path.is_file():
        raise SpecError(f"no {path.name} at {path.parent}")
    with open(path) as f:
        return json.load(f)


def read_json(path: Path) -> dict:
    if not path.is_file():
        raise SpecError(f"missing {path.relative_to(ROOT)}")
    with open(path) as f:
        return json.load(f)


def load_module(path: Path):
    """The Python file at `path` as a module (file names may hold '-' and
    '.', so they are loaded by path, not by import name)."""
    if not path.is_file():
        raise SpecError(f"missing {path.relative_to(ROOT)}")
    name = "benchmark_plugin_" + re.sub(r"\W", "_", str(
        path.relative_to(HERE).with_suffix("")))
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def cell(spec: dict, name: str) -> dict:
    for w in spec["workloads"]:
        if w["name"] == name:
            return w
    raise SpecError(f"no workload {name!r} in BENCHMARK.json")


def config_entry(spec: dict, name: str) -> dict:
    for c in spec["configs"]:
        if c["name"] == name:
            return c
    raise SpecError(f"no config {name!r} in BENCHMARK.json")


def config_files(name: str):
    """(configs/<name>.json as a dict, configs/<name>.py as a module)."""
    return (read_json(HERE / "configs" / f"{name}.json"),
            load_module(HERE / "configs" / f"{name}.py"))


def traffic(name: str) -> dict:
    return read_json(HERE / "traffic" / f"{name}.json")


def driver(name: str):
    return load_module(HERE / "drivers" / f"{name}.py")


def metric_reader(name: str):
    """metrics/<name>.py, else metrics/<base>.py for `<base>.<suffix>`."""
    full = HERE / "metrics" / f"{name}.py"
    if full.is_file():
        return load_module(full)
    return load_module(HERE / "metrics" / f"{name.split('.')[0]}.py")


def roofline(layer: str):
    return load_module(HERE / "rooflines" / f"{layer}.py")


def limits(cell_name: str) -> dict:
    return read_json(HERE / "checks" / f"{cell_name}.json")


def metrics_of(spec: dict, cell_name: str, group: str) -> list:
    """The `end_to_end` or `per_layer` metrics that `cell_name` reports:
    those with no `workloads` key and those that list it."""
    return [m for m in spec[group]
            if "workloads" not in m or cell_name in m["workloads"]]


def forbidden_loaded() -> list:
    """Loaded modules whose top-level name (the part before the first
    dot, compared whole) is in FORBIDDEN."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def emit(result: dict, checks: list):
    """Print the checks (name, value, limit) as the last lines of stderr
    and the result as the last line of stdout, the checks as its last
    key."""
    out = dict(result)
    out["checks"] = {c[0]: {"value": c[1], "limit": c[2]} for c in checks}
    for name, value, limit in checks:
        print(f"check {name}: {value!r} (limit {limit!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
