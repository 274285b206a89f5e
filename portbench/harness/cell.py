"""Finding a cell's parts by name: its entry in ``BENCHMARK.json``, the
workload file ``workloads/<cell>.json``, the configuration's file
``configs/<config>.json`` with its plain reference ``configs/<config>.py``,
the traffic driver ``drivers/<driver>.py`` that the workload file names,
and a reader ``metrics/<metric>.py`` for each per-layer metric. A cell, a
configuration or a metric is added by adding such files and entries.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import List

HERE = Path(__file__).resolve().parent.parent  # the benchmark's folder


def load_module(path: Path, name: str) -> ModuleType:
    """The module in the file ``path`` (its name may hold dots)."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config_name: str
    traffic: str
    workload: dict  # workloads/<cell>.json
    config: dict  # configs/<config>.json
    end_to_end: List[dict]  # the BENCHMARK.json entries this cell reports
    per_layer: List[dict]

    def reference(self) -> ModuleType:
        return load_module(HERE / "configs" / f"{self.config_name}.py",
                           f"portbench_ref_{self.config_name}")

    def driver(self) -> ModuleType:
        kind = self.workload["driver"]
        return load_module(HERE / "drivers" / f"{kind}.py", f"portbench_driver_{kind}")

    def reader(self, metric: str) -> ModuleType:
        return load_module(HERE / "metrics" / f"{metric}.py", f"portbench_metric_{metric}")


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(root: Path, name: str) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json``."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    entries = [w for w in bench["workloads"] if w["name"] == name]
    if not entries:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    entry = entries[0]
    workload = json.loads((HERE / "workloads" / f"{name}.json").read_text())
    if workload.get("traffic") != entry["traffic"]:
        raise ValueError(f"workloads/{name}.json is traffic {workload.get('traffic')!r}, "
                         f"BENCHMARK.json says {entry['traffic']!r}")
    cfg_entry = [c for c in bench["configs"] if c["name"] == entry["config"]][0]
    config = json.loads((root / cfg_entry["file"]).read_text())
    e2e = [m for m in bench["end_to_end"] if _reports(m, name)]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if ("workloads" in m and name in m["workloads"])
                 or ("workloads" not in m and m["moves"] in reported)]
    return Cell(name=name, chips=int(entry["chips"]), config_name=entry["config"],
                traffic=entry["traffic"], workload=workload, config=config,
                end_to_end=e2e, per_layer=per_layer)
