"""``BENCHMARK.json`` and the files it names, loaded and checked.

Everything that belongs to one configuration, traffic mix, cell or
per-layer metric is a file of its own, found by its name:

  configs/<file>           the model configuration (the ``file`` of its
                           ``configs`` entry): the source's keys, cut in
                           ``reduced``, and under ``as_run`` the values
                           the port's model runs with where it departs
                           from the source
  traffic/<traffic>.json   a traffic mix: parameters of the one generator
  cells/<cell>.json        a cell's job options and its limits
  metrics/<metric>.py      a metric's reader, ``read(run) -> float | None``

A later change adds a cell, a mix or a metric by adding files and
entries; nothing here names one.  Every loader refuses a name, unit or
key outside the contract, so a bad file fails before any run.
"""

from __future__ import annotations

import importlib.util
import json
import re
from dataclasses import dataclass
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}\Z")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}\Z")
SOURCES = ("device_trace", "program_span", "program_counter", "host_clock")
END_TO_END_SOURCES = ("host_clock", "device_trace")

TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"}
CONFIG_ENTRY_KEYS = {"name", "source", "file", "reduced", "why"}
WORKLOAD_KEYS = {"name", "config", "traffic", "chips", "why"}
END_TO_END_KEYS = {"name", "unit", "better", "bound", "source"}
PER_LAYER_KEYS = {"name", "unit", "better", "source", "layer", "moves"}

CONFIG_FILE_KEYS = {"name", "source", "config", "reduced", "published",
                    "assumed", "departures", "deployment"}
CONFIG_FILE_OPTIONAL = {"as_run"}
TRAFFIC_KEYS = {"generator", "batch", "seq_len", "zipf_exponent",
                "pool_batches"}
CELL_KEYS = {"mesh", "remat", "remat_policy", "chunked_ce", "check_steps",
             "profile_steps", "limits"}
MESH_DIMS = ("dp", "fsdp", "tp", "ep")
# the numbers harness/check.py reads, any of which a cell may compare
LIMIT_NAMES = ("loss_gap", "loss1_gap", "grad_gap", "grad_median_gap",
               "change_gap", "change_median_gap")


class SpecError(ValueError):
    """A file of the benchmark breaks the contract."""


def check_name(value, what: str) -> str:
    if not isinstance(value, str) or not NAME.match(value):
        raise SpecError(f"{what}: {value!r} is not a name (a letter, digit "
                        f"or _ first, then up to 63 of letters, digits, "
                        f"_ . -)")
    return value


def check_text(value, what: str) -> str:
    if (not isinstance(value, str) or not 1 <= len(value) <= 200
            or "\n" in value or "\t" in value):
        raise SpecError(f"{what}: {value!r} is not 1-200 characters on one "
                        f"line without a tab")
    return value


def check_keys(obj, required: set, what: str, optional: set = frozenset()
               ) -> dict:
    if not isinstance(obj, dict):
        raise SpecError(f"{what}: not a JSON object")
    unknown = set(obj) - required - optional
    missing = required - set(obj)
    if unknown or missing:
        raise SpecError(f"{what}: unknown keys {sorted(unknown)}, missing "
                        f"keys {sorted(missing)}")
    return obj


def _metric(m: dict, keys: set, what: str, sources) -> dict:
    check_keys(m, keys, what, {"workloads"})
    check_name(m["name"], f"{what} name")
    if not isinstance(m["unit"], str) or not UNIT.match(m["unit"]):
        raise SpecError(f"{what} {m['name']}: unit {m['unit']!r} is not "
                        f"1-16 of letters, digits, _ / % . -")
    if m["better"] not in ("lower", "higher"):
        raise SpecError(f"{what} {m['name']}: better must be lower or higher")
    if m["source"] not in sources:
        raise SpecError(f"{what} {m['name']}: source {m['source']!r} not in "
                        f"{sources}")
    if "workloads" in m:
        if not isinstance(m["workloads"], list) or not m["workloads"]:
            raise SpecError(f"{what} {m['name']}: workloads must be a "
                            f"non-empty list")
        for w in m["workloads"]:
            check_name(w, f"{what} {m['name']} workload")
    return m


def check_benchmark(spec: dict) -> dict:
    """Refuse a ``BENCHMARK.json`` outside the contract's shapes."""
    check_keys(spec, TOP_KEYS, "BENCHMARK.json")
    cmd = spec["command"]
    if (not isinstance(cmd, list) or not 1 <= len(cmd) <= 32
            or not all(isinstance(c, str) for c in cmd)):
        raise SpecError("command: a list of 1-32 strings")
    for word in cmd:
        check_text(word, "command word")
    paths = spec["paths"]
    if not isinstance(paths, list) or not 1 <= len(paths) <= 16:
        raise SpecError("paths: 1-16 directories")
    for p in paths:
        if (not isinstance(p, str) or not re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p)
                or p.startswith("/") or ".." in p.split("/")):
            raise SpecError(f"paths: {p!r} is not a relative path inside the "
                            f"checkout")
    rs = spec["run_seconds"]
    if not isinstance(rs, int) or isinstance(rs, bool) or not 1 <= rs <= 51:
        raise SpecError("run_seconds: a whole number from 1 to 51")
    if not 1 <= len(spec["configs"]) <= 24:
        raise SpecError("configs: 1-24 entries")
    if not 1 <= len(spec["workloads"]) <= 24:
        raise SpecError("workloads: 1-24 cells")
    if not 1 <= len(spec["end_to_end"]) <= 16:
        raise SpecError("end_to_end: 1-16 metrics")
    if not 1 <= len(spec["per_layer"]) <= 128:
        raise SpecError("per_layer: 1-128 metrics")
    configs = {}
    for c in spec["configs"]:
        check_keys(c, CONFIG_ENTRY_KEYS, "configs entry")
        check_name(c["name"], "config name")
        check_text(c["source"], f"config {c['name']} source")
        check_text(c["why"], f"config {c['name']} why")
        if not isinstance(c["reduced"], list) or len(c["reduced"]) > 16:
            raise SpecError(f"config {c['name']}: reduced is a list of at "
                            f"most 16 keys")
        for k in c["reduced"]:
            check_name(k, f"config {c['name']} reduced key")
        if c["name"] in configs:
            raise SpecError(f"config {c['name']} named twice")
        configs[c["name"]] = c
    files = [c["file"] for c in configs.values()]
    if len(set(files)) != len(files):
        raise SpecError("two configurations share a file")
    cells, pairs = {}, set()
    for w in spec["workloads"]:
        check_keys(w, WORKLOAD_KEYS, "workloads entry")
        for key in ("name", "config", "traffic"):
            check_name(w[key], f"workload {key}")
        check_text(w["why"], f"workload {w['name']} why")
        if w["config"] not in configs:
            raise SpecError(f"workload {w['name']}: unknown config "
                            f"{w['config']!r}")
        if w["chips"] not in (1, 4):
            raise SpecError(f"workload {w['name']}: chips must be 1 or 4")
        if w["name"] in cells or (w["config"], w["traffic"]) in pairs:
            raise SpecError(f"workload {w['name']}: name or (config, "
                            f"traffic) pair repeated")
        cells[w["name"]] = w
        pairs.add((w["config"], w["traffic"]))
    unused = set(configs) - {w["config"] for w in cells.values()}
    if unused:
        raise SpecError(f"configs used by no cell: {sorted(unused)}")
    names = set()
    for m in spec["end_to_end"]:
        _metric(m, END_TO_END_KEYS, "end_to_end metric", END_TO_END_SOURCES)
        b = m["bound"]
        if not isinstance(b, (int, float)) or not 0 < b <= 0.25:
            raise SpecError(f"end_to_end {m['name']}: bound in (0, 0.25]")
        names.add(m["name"])
    if "setup_s" not in names:
        raise SpecError("end_to_end: setup_s is required")
    for m in spec["per_layer"]:
        _metric(m, PER_LAYER_KEYS, "per_layer metric", SOURCES)
        check_text(m["layer"], f"per_layer {m['name']} layer")
        if m["moves"] not in names:
            raise SpecError(f"per_layer {m['name']}: moves {m['moves']!r} is "
                            f"no end-to-end metric")
        if m["name"] in names:
            raise SpecError(f"metric {m['name']} named twice")
        names.add(m["name"])
    for m in spec["end_to_end"] + spec["per_layer"]:
        for w in m.get("workloads", ()):
            if w not in cells:
                raise SpecError(f"metric {m['name']}: unknown cell {w!r}")
    return spec


@dataclass(frozen=True)
class Cell:
    """One cell with everything its files say."""
    name: str
    chips: int
    config_name: str
    config: dict          # the configuration file
    traffic_name: str
    traffic: dict         # the traffic file
    job: dict             # the cell file
    end_to_end: tuple     # the metric entries this cell reports
    per_layer: tuple
    root: Path

    @property
    def bench_dir(self) -> Path:
        return self.root / "benchmark"


def _load_json(path: Path, what: str) -> dict:
    try:
        with open(path) as f:
            return json.load(f)
    except FileNotFoundError:
        raise SpecError(f"{what}: no file {path}") from None


def check_config_file(cfg: dict, entry: dict) -> dict:
    """Refuse a configuration file outside the contract; return it with
    ``config`` as it is run (``as_run`` over the source's values)."""
    check_keys(cfg, CONFIG_FILE_KEYS, f"config file of {entry['name']}",
               CONFIG_FILE_OPTIONAL)
    if cfg["name"] != entry["name"] or cfg["source"] != entry["source"]:
        raise SpecError(f"config file of {entry['name']}: its name and "
                        f"source must be the entry's")
    if sorted(cfg["reduced"]) != sorted(entry["reduced"]):
        raise SpecError(f"config {entry['name']}: reduced differs between "
                        f"BENCHMARK.json and its file")
    if set(cfg["published"]) != set(cfg["reduced"]):
        raise SpecError(f"config {entry['name']}: published must give the "
                        f"source's value of each reduced key")
    missing = set(cfg["reduced"]) - set(cfg["config"])
    if missing:
        raise SpecError(f"config {entry['name']}: reduced keys not in "
                        f"config: {sorted(missing)}")
    as_run = cfg.get("as_run", {})
    if not isinstance(as_run, dict):
        raise SpecError(f"config {entry['name']}: as_run is an object")
    if set(as_run) - set(cfg["config"]) or set(as_run) & set(cfg["reduced"]):
        raise SpecError(f"config {entry['name']}: each as_run key departs "
                        f"from a source value in config, and is no cut of "
                        f"reduced")
    return {**cfg, "config": {**cfg["config"], **as_run}}


def check_traffic(t: dict, name: str) -> dict:
    check_keys(t, TRAFFIC_KEYS, f"traffic {name}")
    if t["generator"] != "zipf_tokens":
        raise SpecError(f"traffic {name}: unknown generator "
                        f"{t['generator']!r}")
    for key in ("batch", "seq_len", "pool_batches"):
        v = t[key]
        if not isinstance(v, int) or isinstance(v, bool) or v < 1:
            raise SpecError(f"traffic {name}: {key} must be a whole number "
                            f">= 1")
    if not isinstance(t["zipf_exponent"], (int, float)) or t[
            "zipf_exponent"] < 0:
        raise SpecError(f"traffic {name}: zipf_exponent must be >= 0")
    return t


def check_cell_file(job: dict, name: str, chips: int) -> dict:
    check_keys(job, CELL_KEYS, f"cell file {name}")
    mesh = job["mesh"]
    if mesh is not None:
        check_keys(mesh, set(MESH_DIMS), f"cell {name} mesh")
        n = 1
        for d in MESH_DIMS:
            if not isinstance(mesh[d], int) or mesh[d] < 1:
                raise SpecError(f"cell {name}: mesh dim {d} must be >= 1")
            n *= mesh[d]
        if n != chips:
            raise SpecError(f"cell {name}: the mesh holds {n} ranks, the "
                            f"cell asks for {chips} chips")
    elif chips != 1:
        raise SpecError(f"cell {name}: {chips} chips need a mesh")
    if not 2 <= job["check_steps"] <= 3:
        raise SpecError(f"cell {name}: check_steps is 2 or 3")
    limits = job["limits"]
    if not isinstance(limits, dict) or not limits:
        raise SpecError(f"cell {name}: limits name the numbers compared")
    check_keys(limits, set(), f"cell {name} limits", set(LIMIT_NAMES))
    for key, value in limits.items():
        if value is not None and (not isinstance(value, (int, float))
                                  or value < 0):
            raise SpecError(f"cell {name}: limit {key} must be >= 0 or "
                            f"null")
    return job


def load(root: Path | str = ROOT) -> dict:
    """``BENCHMARK.json`` at ``root``, checked."""
    root = Path(root)
    return check_benchmark(_load_json(root / "BENCHMARK.json",
                                      "BENCHMARK.json"))


def applies(metric: dict, cell: dict) -> bool:
    return cell["name"] in metric.get("workloads", [cell["name"]])


def cell(name: str, root: Path | str = ROOT) -> Cell:
    """The cell ``name`` with its configuration, traffic, job options and
    metrics, each read from its own file."""
    root = Path(root)
    spec = load(root)
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise SpecError(f"unknown workload {name!r}; known: "
                        f"{sorted(cells)}")
    w = cells[name]
    entry = next(c for c in spec["configs"] if c["name"] == w["config"])
    bench = root / "benchmark"
    cfg = check_config_file(_load_json(root / entry["file"],
                                       f"config {entry['name']}"), entry)
    traffic = check_traffic(_load_json(
        bench / "traffic" / f"{w['traffic']}.json",
        f"traffic {w['traffic']}"), w["traffic"])
    job = check_cell_file(_load_json(bench / "cells" / f"{name}.json",
                                     f"cell {name}"), name, w["chips"])
    e2e = tuple(m for m in spec["end_to_end"] if applies(m, w))
    layer = tuple(m for m in spec["per_layer"] if applies(m, w))
    return Cell(name, w["chips"], w["config"], cfg, w["traffic"], traffic,
                job, e2e, layer, root)


def reader(metric: str, bench_dir: Path):
    """The ``read`` function of ``metrics/<metric>.py``."""
    path = bench_dir / "metrics" / f"{metric}.py"
    if not path.is_file():
        raise SpecError(f"metric {metric}: no reader {path}")
    mod_spec = importlib.util.spec_from_file_location(
        f"benchmark_metric_{metric.replace('.', '_').replace('-', '_')}",
        path)
    module = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(module)
    return module.read
