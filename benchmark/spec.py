"""A cell of ``BENCHMARK.json`` with everything it names: the
configuration file and the architecture it names, the traffic mix, the
limits of the check and the metrics it reports. Every name is looked up
as a file under the benchmark's folder, so a new configuration,
architecture, mix or metric is a new file and a new entry, and no file
here changes."""

from __future__ import annotations

import importlib.util
import json
import sys
from dataclasses import dataclass
from pathlib import Path

from . import traffic

ROOT = Path(__file__).resolve().parent.parent


@dataclass
class Cell:
    root: Path
    name: str
    chips: int
    arch: object            # the module benchmark/archs/<arch>.py
    model: object           # arch.load(the configuration file)
    mix: dict
    limits: dict
    end_to_end: list
    per_layer: list

    @property
    def folder(self) -> Path:
        return self.root / "benchmark"


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: Path | None = None) -> Cell:
    """The workload `name` of `root`/BENCHMARK.json (root: the checkout
    holding this folder)."""
    root = ROOT if root is None else Path(root)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    wl = next((w for w in bench["workloads"] if w["name"] == name), None)
    if wl is None:
        raise KeyError(f"no workload {name!r} in {root / 'BENCHMARK.json'}")
    conf = next(c for c in bench["configs"] if c["name"] == wl["config"])
    folder = root / "benchmark"
    raw = json.loads((root / conf["file"]).read_text())
    arch = load_arch(root, raw["arch"])
    return Cell(
        root=root, name=name, chips=int(wl["chips"]), arch=arch,
        model=arch.load(raw),
        mix=traffic.load(folder / "traffic" / f"{wl['traffic']}.json"),
        limits=json.loads(
            (folder / "limits" / f"{conf['name']}.json").read_text()),
        end_to_end=[m for m in bench["end_to_end"] if _applies(m, name)],
        per_layer=[m for m in bench["per_layer"] if _applies(m, name)])


def load_file_module(path: Path, name: str):
    """The module in file `path` (names may hold dots, so not by import),
    entered in sys.modules under `name` as it runs (dataclasses look
    their module up there)."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def load_arch(root: Path, stem: str):
    """The architecture module benchmark/archs/<stem>.py of checkout
    `root` (its surface: benchmark/archs/__init__.py)."""
    rel = f"benchmark/archs/{stem}.py"
    if not (Path(root) / rel).is_file():
        raise FileNotFoundError(f"no architecture file {rel} in {root}")
    return load_file_module(Path(root) / rel, f"benchmark_arch_{stem}")


def kind(cell: Cell):
    """The module that drives the mix's kind: benchmark/kinds/<kind>.py."""
    name = cell.mix["kind"]
    return load_file_module(cell.folder / "kinds" / f"{name}.py",
                            f"benchmark_kind_{name}")


def reader(cell: Cell, metric: str):
    """The reader of `metric`: benchmark/metrics/<metric>.py's read()."""
    return load_file_module(cell.folder / "metrics" / f"{metric}.py",
                            f"benchmark_metric_{metric}").read
