"""BENCHMARK.json and the files it names, found by name.

A cell `<cell>` is `workloads/<cell>.json`; its configuration `<config>` is
`configs/<config>.json`; its traffic mix `<traffic>` is the data file
`traffic/<traffic>.json`, which `benchlib/traffic.py` reads; its entry
`<entry>` is `entries/<entry>.py`; a per-layer metric `<metric>` is
`metrics/<metric>.py`. Adding a configuration, a traffic mix, a cell or a
metric is adding files: nothing here lists them.
"""

from __future__ import annotations

import importlib.util
import json
import os
import re
from dataclasses import dataclass
from types import ModuleType

NAME_RE = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT_RE = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = ("device_trace", "program_span", "program_counter", "host_clock")
E2E_SOURCES = ("device_trace", "host_clock")


@dataclass
class Cell:
    name: str
    spec: dict          # the cell's entry in BENCHMARK.json
    workload: dict      # workloads/<cell>.json
    config: dict        # configs/<config>.json
    traffic: dict       # traffic/<traffic>.json
    end_to_end: list    # the end-to-end metrics this cell reports
    per_layer: list     # the per-layer metrics this cell reports


class Bench:
    """The benchmark folder (`bench_dir`, holding configs/, workloads/, ...)
    and its manifest (`manifest_path`, BENCHMARK.json at the repo root)."""

    def __init__(self, bench_dir: str, manifest_path: str | None = None):
        self.dir = os.path.abspath(bench_dir)
        self.manifest_path = manifest_path or os.path.join(
            os.path.dirname(self.dir), "BENCHMARK.json")
        with open(self.manifest_path) as f:
            self.manifest = json.load(f)

    def path(self, *parts: str) -> str:
        return os.path.join(self.dir, *parts)

    def load_json(self, folder: str, name: str) -> dict:
        p = self.path(folder, f"{name}.json")
        if not os.path.exists(p):
            raise FileNotFoundError(f"no file in {folder}/ named {name!r} ({p})")
        with open(p) as f:
            return json.load(f)

    def module(self, folder: str, name: str) -> ModuleType:
        """`<folder>/<name>.py` as a module (names may hold dots)."""
        p = self.path(folder, f"{name}.py")
        if not os.path.exists(p):
            raise FileNotFoundError(f"no {folder} module named {name!r} ({p})")
        key = f"_bench_{folder}_" + re.sub(r"\W", "_", name)
        spec = importlib.util.spec_from_file_location(key, p)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod

    def cell(self, name: str) -> Cell:
        specs = {w["name"]: w for w in self.manifest["workloads"]}
        if name not in specs:
            raise KeyError(f"no cell {name!r} in {self.manifest_path}; "
                           f"cells: {sorted(specs)}")
        spec = specs[name]
        workload = self.load_json("workloads", name)
        for key in ("config", "traffic"):
            if workload.get(key) != spec[key]:
                raise ValueError(f"{name}: workloads/{name}.json names {key} "
                                 f"{workload.get(key)!r}, BENCHMARK.json {spec[key]!r}")
        config = self.load_json("configs", spec["config"])
        traffic = self.load_json("traffic", spec["traffic"])

        def here(metric):
            return name in metric.get("workloads", [name])

        return Cell(name, spec, workload, config, traffic,
                    [m for m in self.manifest["end_to_end"] if here(m)],
                    [m for m in self.manifest["per_layer"] if here(m)])


def check_manifest(m: dict) -> list[str]:
    """The faults of a manifest against the benchmark contract's naming
    rules (names, units, sources, cross-references); empty when sound."""
    bad = []
    names = set()
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in m.get(group, []):
            n = e.get("name", "")
            if not NAME_RE.match(n):
                bad.append(f"{group}: bad name {n!r}")
            if (group, n) in names:
                bad.append(f"{group}: {n!r} twice")
            names.add((group, n))
    cfgs = {c["name"] for c in m.get("configs", [])}
    cells = {w["name"] for w in m.get("workloads", [])}
    e2e = {x["name"] for x in m.get("end_to_end", [])}
    for w in m.get("workloads", []):
        if w.get("config") not in cfgs:
            bad.append(f"cell {w['name']}: unknown config {w.get('config')!r}")
        if not NAME_RE.match(str(w.get("traffic", ""))):
            bad.append(f"cell {w['name']}: bad traffic {w.get('traffic')!r}")
        if w.get("chips") not in (1, 4):
            bad.append(f"cell {w['name']}: chips {w.get('chips')!r}")
    for c in m.get("configs", []):
        for k in c.get("reduced", []):
            if not NAME_RE.match(k):
                bad.append(f"config {c['name']}: bad reduced key {k!r}")
    for group, sources in (("end_to_end", E2E_SOURCES), ("per_layer", SOURCES)):
        for x in m.get(group, []):
            if not UNIT_RE.match(x.get("unit", "")):
                bad.append(f"{x['name']}: bad unit {x.get('unit')!r}")
            if x.get("better") not in ("lower", "higher"):
                bad.append(f"{x['name']}: better {x.get('better')!r}")
            if x.get("source") not in sources:
                bad.append(f"{x['name']}: source {x.get('source')!r}")
            for cell in x.get("workloads", []):
                if cell not in cells:
                    bad.append(f"{x['name']}: unknown cell {cell!r}")
    for x in m.get("per_layer", []):
        if x.get("moves") not in e2e:
            bad.append(f"{x['name']}: moves {x.get('moves')!r}")
    return bad
