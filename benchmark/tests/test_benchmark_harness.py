"""The spec and the files it names: names and units, every cell's files
found by name, a new file picked up with no edit, and the run's refusal
without a card.  The test marked `gpu` runs a cell on the card and skips
inside the test where there is none.

    python -m pytest benchmark/tests            (CPU)
    python -m pytest benchmark/tests -m gpu     (on the card)
"""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

import pytest

from benchmark import harness

ROOT = str(harness.ROOT)
SPEC = harness.load_spec()
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}


def test_top_level_keys_and_sizes():
    assert set(SPEC) == KEYS
    assert os.path.getsize(harness.SPEC_FILE) <= 64 * 1024
    assert 1 <= SPEC["run_seconds"] <= 51
    assert 1 <= len(SPEC["paths"]) <= 16
    for p in SPEC["paths"]:
        assert os.path.isdir(os.path.join(ROOT, p)) and not p.startswith("/")
    assert len(SPEC["command"]) <= 32


@pytest.mark.parametrize("group", ["configs", "workloads", "end_to_end",
                                   "per_layer"])
def test_names_and_units(group):
    names = [e["name"] for e in SPEC[group]]
    assert len(names) == len(set(names))
    for e in SPEC[group]:
        assert harness.NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert harness.UNIT.match(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")
        for k in ("why", "layer", "source"):
            if isinstance(e.get(k), str):
                assert 1 <= len(e[k]) <= 200 and "\n" not in e[k] \
                    and "\t" not in e[k]
        for key in e.get("reduced", []):
            assert harness.NAME.match(key)


def test_entry_keys():
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4)
    for m in SPEC["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in SPEC["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "source", "layer", "moves"}
    assert any(m["name"] == "setup_s" for m in SPEC["end_to_end"])


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_cell_files_resolve(cell):
    w = harness.cell(SPEC, cell)
    entry = harness.config_entry(SPEC, w["config"])
    assert os.path.isfile(os.path.join(ROOT, entry["file"]))
    cfg, mod = harness.config_files(w["config"])
    assert callable(mod.build)
    traffic = harness.traffic(w["traffic"])
    assert hasattr(harness.driver(traffic["driver"]), "Run")
    assert isinstance(harness.limits(cell), dict)
    e2e = harness.metrics_of(SPEC, cell, "end_to_end")
    assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2
    layer = harness.metrics_of(SPEC, cell, "per_layer")
    assert layer
    moved = {m["name"] for m in e2e}
    for m in layer:
        assert m["moves"] in moved
        assert callable(harness.metric_reader(m["name"]).read)


def test_every_layer_count_counts():
    work = {"kind": "train", "P": 8, "K": 9, "W": 32, "H": 16, "Hs": 16,
            "Ws": 32, "B": 4, "S": 5, "visible": 3, "tiles": 1,
            "net_width": 32,
            "blends": [{"mode": "render_geo", "walked": 10, "n_inst": 3,
                        "pixels": 512, "contrib": 5}]}
    for path in sorted((harness.HERE / "rooflines").glob("*.py")):
        out = harness.roofline(path.stem).count(work)
        assert out and all(v > 0 for v in out.values())


def _copy_benchmark(tmp_path):
    shutil.copytree(harness.HERE, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(harness.SPEC_FILE, tmp_path / "BENCHMARK.json")
    return tmp_path / "benchmark"


def test_new_files_are_found_without_an_edit(tmp_path, monkeypatch):
    """A config, traffic mix, driver, metric reader, layer count and
    limits added as files are found by name; no file changes."""
    here = _copy_benchmark(tmp_path)
    before = {p: p.read_bytes() for p in here.rglob("*.py")}
    (here / "metrics" / "new_metric.py").write_text(
        "def read(ctx):\n    return 42.0\n")
    (here / "rooflines" / "newlayer.py").write_text(
        "def count(work):\n    return {'ops': 1}\n")
    (here / "configs" / "newcfg.json").write_text('{"x": 1}')
    (here / "configs" / "newcfg.py").write_text(
        "def build(cfg, traffic, seed, device):\n    return cfg\n")
    (here / "traffic" / "newmix.json").write_text('{"driver": "newdrv"}')
    (here / "drivers" / "newdrv.py").write_text("class Run:\n    pass\n")
    (here / "checks" / "newcfg.newmix.json").write_text('{"gap": 1}')
    monkeypatch.setattr(harness, "HERE", here)
    monkeypatch.setattr(harness, "ROOT", tmp_path)
    assert harness.metric_reader("new_metric.train").read({}) == 42.0
    assert harness.roofline("newlayer").count({}) == {"ops": 1}
    cfg, mod = harness.config_files("newcfg")
    assert mod.build(cfg, None, 0, None) == {"x": 1}
    assert hasattr(harness.driver(harness.traffic("newmix")["driver"]),
                   "Run")
    assert harness.limits("newcfg.newmix") == {"gap": 1}
    for p, b in before.items():
        assert p.read_bytes() == b


def _run(args, env_extra, cwd):
    env = dict(os.environ, **env_extra)
    env["PYTHONPATH"] = ""
    return subprocess.run([sys.executable, "-m", "benchmark.run", *args],
                          cwd=cwd, env=env, capture_output=True, text=True,
                          timeout=300)


def test_run_without_a_card_exits_non_zero():
    cell = SPEC["workloads"][0]["name"]
    r = _run(["--workload", cell, "--seed", str(2 ** 31 + 7), "--seconds",
              "1", "--trace", "0"], {"CUDA_VISIBLE_DEVICES": ""}, ROOT)
    assert r.returncode != 0
    assert not r.stdout.strip()
    assert "no CUDA device" in r.stderr


def test_run_without_the_program_exits_non_zero(tmp_path):
    """A checkout that holds only BENCHMARK.json and the benchmark."""
    _copy_benchmark(tmp_path)
    cell = SPEC["workloads"][0]["name"]
    r = _run(["--workload", cell, "--seed", "5", "--seconds", "1",
              "--trace", "0"], {}, str(tmp_path))
    assert r.returncode != 0
    assert not r.stdout.strip()


def test_forbidden_names_compare_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "ibgs_tpu_torch_fake.sub", object())
    monkeypatch.setitem(sys.modules, "jaxlike", object())
    assert harness.forbidden_loaded() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    assert harness.forbidden_loaded() == ["jax"]


@pytest.mark.gpu
def test_a_cell_runs_on_the_card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cell = SPEC["workloads"][0]["name"]
    r = _run(["--workload", cell, "--seed", str(2 ** 31 + 11), "--seconds",
              "2", "--trace", "0"], {}, ROOT)
    assert r.returncode == 0, r.stderr[-2000:]
    line = json.loads(r.stdout.strip().splitlines()[-1])
    assert set(line) >= {"correct", "attempted", "failed", "metrics",
                         "device"}
    assert line["device"]["platform"] == "gpu"
    assert "setup_s" in line["metrics"]
