"""Finding a cell's parts by name.

``BENCHMARK.json`` names each cell's configuration and traffic mix; the
harness reads ``perfbench/configs/<config>.json``,
``perfbench/traffic/<mix>.json`` and ``perfbench/cells/<cell>.json``
(the engine's settings, the cell's rate and its correctness limits), the
metric readers ``perfbench/metrics/<metric>.py`` (or, for a metric named
``<base>.<suffix>``, ``<base>.py``) and the kernel classes
``perfbench/kernel_classes/<class>.json``. A new cell, mix, metric or
kernel class is a new file; no file here changes.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from typing import Dict, List


class CellError(Exception):
    """The benchmark's files do not describe the named cell."""


def _read(path: Path) -> Dict:
    if not path.is_file():
        raise CellError(f"missing {path}")
    return json.loads(path.read_text())


@dataclasses.dataclass
class Metric:
    name: str
    unit: str
    reader: object  # module with read(run) -> Optional[float]


@dataclasses.dataclass
class Cell:
    root: Path
    name: str
    chips: int
    config: Dict
    mix_name: str
    mix: Dict
    settings: Dict
    end_to_end: List[Metric]
    per_layer: List[Metric]

    def kernel_patterns(self, cls: str) -> List[str]:
        """The name fragments of kernel class ``cls`` (lower case)."""
        spec = _read(self.root / "perfbench" / "kernel_classes"
                     / f"{cls}.json")
        return [p.lower() for p in spec["patterns"]]


def _reader(root: Path, name: str):
    folder = root / "perfbench" / "metrics"
    for stem in (name, name.split(".")[0]):
        path = folder / f"{stem}.py"
        if path.is_file():
            spec = importlib.util.spec_from_file_location(
                f"perfbench_metric_{stem.replace('.', '_')}", path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            return mod
    raise CellError(f"no reader for metric {name!r} under {folder}")


def _metrics(root: Path, entries: List[Dict], cell: str) -> List[Metric]:
    out = []
    for e in entries:
        if "workloads" in e and cell not in e["workloads"]:
            continue
        out.append(Metric(e["name"], e["unit"], _reader(root, e["name"])))
    return out


def load(root: Path, workload: str) -> Cell:
    """The cell ``workload`` of the benchmark at ``root``."""
    root = Path(root)
    bench = _read(root / "BENCHMARK.json")
    match = [w for w in bench["workloads"] if w["name"] == workload]
    if not match:
        names = [w["name"] for w in bench["workloads"]]
        raise CellError(f"no workload {workload!r}; have {names}")
    w = match[0]
    base = root / "perfbench"
    return Cell(
        root=root, name=workload, chips=int(w["chips"]),
        config=_read(base / "configs" / f"{w['config']}.json"),
        mix_name=w["traffic"],
        mix=_read(base / "traffic" / f"{w['traffic']}.json"),
        settings=_read(base / "cells" / f"{workload}.json"),
        end_to_end=_metrics(root, bench["end_to_end"], workload),
        per_layer=_metrics(root, bench["per_layer"], workload))
