"""A cell of BENCHMARK.json and the files it is made of, found by name.

A workload entry names a configuration and a traffic mix.  The
configuration is `configs/<config>.json` (the file BENCHMARK.json gives),
with `adapters/<config>.py`, which builds the program's inputs and calls
its entry, and `reference/<config>.py`, the plain reference.  The
traffic is `traffic/<traffic>.json`, read by the module
`generators/<generator>.py` that the file names.  Each metric is
`metrics/<metric>.py`.  Adding a cell, a configuration, a traffic mix or
a metric adds files and entries; it edits none of these modules.
"""

from __future__ import annotations

import dataclasses
import hashlib
import importlib
import importlib.util
import json
import pathlib
import sys
from types import ModuleType
from typing import List

BENCH_DIR = pathlib.Path(__file__).resolve().parent.parent
REPO = BENCH_DIR.parent


def load_module(path: pathlib.Path) -> ModuleType:
    """The Python file at `path` as a module (file names may hold '-')."""
    tag = hashlib.sha1(str(path.resolve()).encode()).hexdigest()[:8]
    name = f"h100_bench._loaded.{path.parent.name}_{path.stem}_{tag}"
    if name not in sys.modules:
        spec = importlib.util.spec_from_file_location(name, path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[name] = mod
        spec.loader.exec_module(mod)
    return sys.modules[name]


def _applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config_name: str
    config: dict
    traffic_name: str
    traffic: dict
    end_to_end: List[dict]
    per_layer: List[dict]
    bench_dir: pathlib.Path

    def _file(self, *parts: str) -> pathlib.Path:
        return self.bench_dir.joinpath(*parts)

    def adapter(self) -> ModuleType:
        return load_module(self._file("adapters", f"{self.config_name}.py"))

    def entry(self):
        """The program's function that the configuration names."""
        module, _, name = self.config["entry"].rpartition(".")
        return getattr(importlib.import_module(module), name)

    def reference_path(self) -> pathlib.Path:
        return self._file("reference", f"{self.config_name}.py")

    def reference(self) -> ModuleType:
        return load_module(self.reference_path())

    def generator(self) -> ModuleType:
        """The traffic's generator, imported as a package module so that
        its batches pickle into the reference's worker processes."""
        return importlib.import_module(
            f"h100_bench.generators.{self.traffic['generator']}")

    def reader(self, metric: str) -> ModuleType:
        return load_module(self._file("metrics", f"{metric}.py"))


def load_cell(workload: str, repo: pathlib.Path = REPO) -> Cell:
    """The cell `workload` of `repo`/BENCHMARK.json."""
    bench = json.loads((repo / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json "
                       f"(it has {sorted(cells)})")
    w = cells[workload]
    config = {c["name"]: c for c in bench["configs"]}[w["config"]]
    bench_dir = (repo / config["file"]).parent.parent
    return Cell(
        name=workload, chips=int(w["chips"]), config_name=w["config"],
        config=json.loads((repo / config["file"]).read_text()),
        traffic_name=w["traffic"],
        traffic=json.loads(
            (bench_dir / "traffic" / f"{w['traffic']}.json").read_text()),
        end_to_end=[m for m in bench["end_to_end"] if _applies(m, workload)],
        per_layer=[m for m in bench["per_layer"] if _applies(m, workload)],
        bench_dir=bench_dir)
