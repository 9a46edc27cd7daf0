"""``BENCHMARK.json`` and the files it names, found by name.

A cell ``<name>`` reads ``bench/workloads/<name>.json`` (its configuration,
ABFT setting, traffic and comparison); its configuration the ``file`` its
entry names; each metric ``<metric>`` its entry in ``BENCHMARK.json``, its
reader ``bench/metrics/<metric>.py`` and, where the reader needs more (the
kernel names a roofline sums), ``bench/metrics/<metric>.json``.  A
configuration's layout is the module its ``layout`` path names
(``bench/layouts/decoder.py`` without one)."""
from __future__ import annotations

import importlib.util
import json
import re
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, List, Optional

BENCH = Path(__file__).resolve().parents[1]


@dataclass
class Metric:
    entry: dict                       # as BENCHMARK.json has it
    extra: dict                       # what the reader needs, if anything
    read: Callable[[object], Optional[float]]

    @property
    def name(self) -> str:
        return self.entry["name"]


@dataclass
class Cell:
    name: str
    chips: int
    workload: dict
    config: dict
    end_to_end: List[Metric] = field(default_factory=list)
    per_layer: List[Metric] = field(default_factory=list)


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _reader(path: Path) -> Callable:
    mod_name = "bench_metric_" + re.sub(r"\W", "_", path.stem)
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _applies(entry: dict, cell: str) -> bool:
    return "workloads" not in entry or cell in entry["workloads"]


def metric(entry: dict) -> Metric:
    name = entry["name"]
    extra = BENCH / "metrics" / f"{name}.json"
    return Metric(entry, load_json(extra) if extra.exists() else {},
                  _reader(BENCH / "metrics" / f"{name}.py"))


def load(root: Path, cell_name: str) -> Cell:
    """The cell ``cell_name`` of ``root/BENCHMARK.json``, its files read."""
    bench = load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if cell_name not in cells:
        raise KeyError(f"no workload {cell_name!r} in BENCHMARK.json "
                       f"(have {sorted(cells)})")
    entry = cells[cell_name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = load_json(root / configs[entry["config"]]["file"])
    workload = load_json(BENCH / "workloads" / f"{cell_name}.json")
    if workload["config"] != entry["config"] or \
            workload["name"] != cell_name:
        raise ValueError(f"bench/workloads/{cell_name}.json names "
                         f"{workload['name']} on {workload['config']}")
    return Cell(
        name=cell_name, chips=int(entry["chips"]), workload=workload,
        config=config,
        end_to_end=[metric(m) for m in bench["end_to_end"]
                    if _applies(m, cell_name)],
        per_layer=[metric(m) for m in bench["per_layer"]
                   if _applies(m, cell_name)])


def _path_module(rel: str):
    """The module at the path ``rel`` (from the checkout's root)."""
    return importlib.import_module(".".join(Path(rel).with_suffix("").parts))


def reference_module(config: dict):
    """The configuration's plain reference (its ``reference`` file)."""
    return _path_module(config["reference"])


def layout_module(config: dict):
    """The configuration's layout (its ``layout`` file, as ``reference``;
    ``bench/layouts/decoder.py`` without one)."""
    return _path_module(config.get("layout", "bench/layouts/decoder.py"))
