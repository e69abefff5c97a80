"""BENCHMARK.json against the benchmark's contract, what the harness and
the reference import, and a run with no card."""
import ast
import json
import os
import re
import subprocess
import sys
import time
import types
from pathlib import Path

import pytest

from bench import harness

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "bench"
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SPEC = harness.load_spec()
CELLS = [w["name"] for w in SPEC["workloads"]]


def _text(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_top_level_keys_and_limits():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["command"] == ["python3", "bench/run.py"]
    assert SPEC["paths"] == ["bench"]
    assert isinstance(SPEC["run_seconds"], int)
    assert 1 <= SPEC["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    n = len(CELLS)
    # a check of 24 cells at this window length fits in 12 hours
    assert (2 + 14 * 24) * (SPEC["run_seconds"] + 60) + 24 * 180 + 1200 \
        <= 43200 and n <= 24


def test_configs_resolve_and_cut_no_shape():
    names = [c["name"] for c in SPEC["configs"]]
    assert len(set(names)) == len(names)
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _text(c["why"])
        assert _text(c["source"]) and c["source"].startswith("https://")
        assert c["file"] == f"bench/configs/{c['name']}.json"
        body = json.loads((ROOT / c["file"]).read_text())
        assert body["source"] == c["source"]
        assert c["reduced"] == body["reduced"]
        assert c["reduced"] == []  # nothing is cut
        assert {"guarantees", "assumed", "n_vertices", "edge_capacity",
                "bucket", "engine", "service"} <= set(body)
        assert any(w["config"] == c["name"] for w in SPEC["workloads"])
    assert len({c["source"] for c in SPEC["configs"]}) == len(names)


@pytest.mark.parametrize("cell", CELLS)
def test_each_cell_resolves_its_files_and_metrics(cell):
    w = harness.cell_of(SPEC, cell)
    assert set(w) == {"name", "config", "traffic", "chips", "why"}
    assert NAME.match(w["name"]) and NAME.match(w["traffic"])
    assert w["chips"] == 1 and _text(w["why"])
    harness.config_of(SPEC, w["config"])
    harness.mix_of(w["traffic"])
    e2e = [m["name"] for m in harness.metrics_of(SPEC, cell, False)]
    assert "setup_s" in e2e and len(e2e) >= 2
    per = harness.metrics_of(SPEC, cell, True)
    assert per and all(m["moves"] in e2e for m in per)
    for m in e2e + [m["name"] for m in per]:
        assert callable(harness.reader_of(m))
    pairs = [(x["config"], x["traffic"]) for x in SPEC["workloads"]]
    assert pairs.count((w["config"], w["traffic"])) == 1


def test_metrics_keep_to_the_contract():
    e2e, per = SPEC["end_to_end"], SPEC["per_layer"]
    names = [m["name"] for m in e2e + per]
    assert len(set(names)) == len(names)
    assert 1 <= len(e2e) <= 16 and 1 <= len(per) <= 128
    for m in e2e:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in per:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert _text(m["layer"])
        if m["name"].endswith("_roofline") or "_roofline." in m["name"]:
            assert m["unit"] == "%"
    for m in e2e + per:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", CELLS)) <= set(CELLS)


def test_a_new_generator_is_found_by_name_and_driven(monkeypatch):
    """A mix names its generator module, and the harness drives whatever
    that module sets up: a new kind of traffic is a new file."""
    class Traffic:
        def __init__(self, config, mix, seed, dev, note):
            self.n, self.chunks, self.requests, self.sizes = 0, [], [], {}

        def workers(self, clock):
            def count():
                clock.go.wait()
                while not clock.stop.is_set():
                    self.n += 1
                    time.sleep(0.001)
            return [count]

        def sync(self):
            pass

        def counters(self):
            return {"n": self.n}

        def finish(self):
            pass

        def check(self, note):
            return {"counted": (0 if self.n else 1, 0)}

        def describe(self):
            return f"{self.n} counted"

    mod = types.ModuleType("bench.traffic.counting")
    mod.check_mix, mod.Traffic = (lambda mix: mix), Traffic
    monkeypatch.setitem(sys.modules, "bench.traffic.counting", mod)
    spec = dict(SPEC, workloads=[{"name": "smscc-1m.count",
                                  "config": "smscc-1m", "traffic": "count",
                                  "chips": 1, "why": "a test"}])
    result, lines = harness.run_cell(
        "smscc-1m.count", 1, 0.2, device="cpu", spec=spec, config={},
        mix={"generator": "counting"}, note=lambda msg: None)
    assert result["correct"] and result["metrics"]["setup_s"]["value"] > 0
    assert lines == ["check counted 0 limit 0", "check unanswered 0 limit 0"]
    with pytest.raises(ValueError):
        harness.generator_of("../window")


def _imports(path: Path) -> set:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            out.add(node.module.split(".")[0])
    return out


def test_the_yardstick_imports_nothing_of_the_programs():
    """The reference, byte counts and readers import neither JAX, the JAX
    package nor the port, and nothing of the benchmark imports JAX or the
    JAX package (names compared whole)."""
    yard = [BENCH / "roofline.py",
            BENCH / "devtrace.py", *(BENCH / "reference").glob("*.py"),
            *(BENCH / "metrics").glob("*.py")]
    for path in yard:
        assert not _imports(path) & {"jax", "jaxlib", "flax", "repro",
                                     "repro_torch"}, path
    for path in BENCH.rglob("*.py"):
        assert not _imports(path) & {"jax", "jaxlib", "flax", "repro"}, path


def _bench_env(**extra):
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    env["OMP_NUM_THREADS"] = "1"  # leave the cores to the other workers
    env.update(extra)
    return env


def test_a_whole_run_loads_no_jax():
    """A run at the tiny size on the CPU, in a fresh process: afterwards
    no module whose top-level name is jax, jaxlib, flax or repro is
    loaded."""
    code = ("from bench.tests import tiny; from bench import harness; "
            "tiny.run('smscc-1m.reach-serve', seconds=0.3); "
            "print(harness.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env=_bench_env(), capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_a_run_without_a_card_fails_and_prints_no_result():
    out = subprocess.run(
        [sys.executable, "bench/run.py", "--workload", CELLS[0], "--seed",
         "3", "--seconds", "1", "--trace", "0"], cwd=ROOT,
        env=_bench_env(CUDA_VISIBLE_DEVICES=""), capture_output=True,
        text=True, timeout=300)
    assert out.returncode != 0
    assert "no CUDA card" in out.stderr
    assert "{" not in out.stdout and "metrics" not in out.stdout
