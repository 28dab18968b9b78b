"""The loaders refuse what the contract refuses, and a cell, a traffic
mix and a metric are added from files alone."""

import copy
import hashlib
import json

import pytest

import tiny_cells
from tiny_cells import ROOT
from benchmark.harness import runner, spec


def _spec():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def test_the_benchmark_loads_every_cell():
    s = spec.load()
    for w in s["workloads"]:
        cell = spec.cell(w["name"])
        assert cell.chips in (1, 4)
        for m in cell.end_to_end + cell.per_layer:
            assert callable(spec.reader(m["name"], cell.bench_dir))
    assert sum(w["chips"] == 4 for w in s["workloads"]) <= max(
        1, len(s["workloads"]) // 4)


@pytest.mark.parametrize("path, value", [
    (("workloads", 0, "name"), "bad name"),
    (("workloads", 0, "name"), "a/b"),
    (("end_to_end", 0, "name"), "x" * 65),
    (("end_to_end", 0, "unit"), "tokens per second"),
    (("end_to_end", 0, "unit"), "µs"),
    (("end_to_end", 0, "better"), "more"),
    (("end_to_end", 0, "bound"), 0.3),
    (("end_to_end", 0, "source"), "program_counter"),
    (("per_layer", 0, "moves"), "no_such_metric"),
    (("workloads", 0, "chips"), 2),
    (("run_seconds",), 52),
    (("workloads", 0, "why"), "two\nlines"),
])
def test_refuses_bad_values(path, value):
    s = copy.deepcopy(_spec())
    obj = s
    for key in path[:-1]:
        obj = obj[key]
    obj[path[-1]] = value
    with pytest.raises(spec.SpecError):
        spec.check_benchmark(s)


@pytest.mark.parametrize("where", ["top", "configs", "workloads",
                                   "end_to_end", "per_layer"])
def test_refuses_unknown_keys(where):
    s = copy.deepcopy(_spec())
    target = s if where == "top" else s[where][0]
    target["extra"] = 1
    with pytest.raises(spec.SpecError):
        spec.check_benchmark(s)


def test_refuses_a_repeated_pair_and_a_missing_setup():
    s = copy.deepcopy(_spec())
    s["workloads"].append(dict(s["workloads"][0], name="other"))
    with pytest.raises(spec.SpecError):
        spec.check_benchmark(s)
    s = copy.deepcopy(_spec())
    s["end_to_end"] = [m for m in s["end_to_end"] if m["name"] != "setup_s"]
    with pytest.raises(spec.SpecError):
        spec.check_benchmark(s)


@pytest.mark.parametrize("kind, bad", [
    ("traffic", {"generator": "zipf_tokens", "batch": 2, "seq_len": 32,
                 "zipf_exponent": 1.0, "pool_batches": 6, "rate": 3}),
    ("traffic", {"generator": "poisson", "batch": 2, "seq_len": 32,
                 "zipf_exponent": 1.0, "pool_batches": 6}),
    ("cells", {"mesh": None, "limits": {}}),
])
def test_refuses_bad_data_files(tmp_path, kind, bad):
    root = tiny_cells.make_root(tmp_path)
    name = "zipf.b2.t32" if kind == "traffic" else "tiny.dense"
    (root / "benchmark" / kind / f"{name}.json").write_text(json.dumps(bad))
    with pytest.raises(spec.SpecError):
        spec.cell("tiny.dense", root)


def test_as_run_gives_the_ports_values_over_the_sources():
    """A configuration file holds the source's values, cut only in
    ``reduced``; where the port's model departs from the source, the
    value it runs with is under ``as_run``, and that is what a run
    reads.  A cut may not hide there, nor a key the source lacks."""
    for entry in spec.load()["configs"]:
        raw = json.loads((ROOT / entry["file"]).read_text())
        got = spec.check_config_file(raw, entry)
        assert got["config"] == {**raw["config"], **raw.get("as_run", {})}
        assert raw["reduced"] == ["num_hidden_layers"]
    entry = spec.load()["configs"][0]
    raw = json.loads((ROOT / entry["file"]).read_text())
    for bad in ({"num_hidden_layers": 4}, {"no_such_key": 1}, [1]):
        with pytest.raises(spec.SpecError):
            spec.check_config_file(dict(raw, as_run=bad), entry)


def _digests(root):
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()
                                                     ).hexdigest()
            for p in sorted((root / "benchmark").rglob("*")) if p.is_file()}


def test_a_cell_a_mix_and_a_metric_from_files_alone(tmp_path):
    """A new configuration, traffic mix, cell and per-layer metric, added
    as new files and new entries of BENCHMARK.json, run through the
    harness: no file the benchmark had is changed."""
    root = tiny_cells.make_root(tmp_path, {})
    before = _digests(root)
    bench = root / "benchmark"
    (bench / "traffic" / "zipf.b1.t48.json").write_text(json.dumps(
        {"generator": "zipf_tokens", "batch": 1, "seq_len": 48,
         "zipf_exponent": 1.2, "pool_batches": 5}))
    (bench / "cells" / "tiny.new.json").write_text(json.dumps(
        tiny_cells._cell_file()))
    (bench / "configs" / "tiny-new.json").write_text(json.dumps(
        tiny_cells._config_file("tiny-new", tiny_cells.TINY_DENSE)))
    (bench / "metrics" / "window_steps.py").write_text(
        '"""window_steps: the window\'s steps (a host count)."""\n\n\n'
        'def read(run):\n    return float(run["steps"])\n')
    s = json.loads((root / "BENCHMARK.json").read_text())
    s["configs"].append({"name": "tiny-new",
                         "source": "https://arxiv.org/abs/2310.06825",
                         "file": "benchmark/configs/tiny-new.json",
                         "reduced": [], "why": "a CPU test"})
    s["workloads"].append({"name": "tiny.new", "config": "tiny-new",
                           "traffic": "zipf.b1.t48", "chips": 1,
                           "why": "a CPU test"})
    s["per_layer"].append({"name": "window_steps", "unit": "steps",
                           "better": "higher", "source": "program_counter",
                           "layer": "step (parallel/train.py)",
                           "moves": "tokens_per_s",
                           "workloads": ["tiny.new"]})
    (root / "BENCHMARK.json").write_text(json.dumps(s))
    line, _, _ = runner.execute("tiny.new", 5, 0.2, True, "cpu", root=root)
    assert line["correct"] is True
    assert line["metrics"]["window_steps"]["value"] >= 1
    after = _digests(root)
    assert {k: v for k, v in after.items() if k in before} == before
