"""The benchmark as data: ``BENCHMARK.json`` at the checkout's root and,
under ``portbench/``, one file per configuration (``configs/``), cell
(``workloads/``), traffic mix (``traffic/``), traffic driver
(``drivers/``) and per-layer metric reader (``metrics/``), each found by
its name. Adding any of them is adding files; no code names a cell.
"""

from __future__ import annotations

import importlib.util
import json
import math
import os
import re
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO_DIR = os.path.dirname(PKG_DIR)
NAME_RE = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT_RE = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@dataclass
class Context:
    """What a driver is given: the cell, its configuration and traffic
    files, the run's arguments and where it may keep caches."""
    cell: Dict[str, Any]
    config: Dict[str, Any]
    traffic: Dict[str, Any]
    seed: int
    seconds: float
    trace: bool
    device: Any
    cache_dir: str
    t0: float
    # Program-side settings a test gives (a CPU run has no graphs).
    program_overrides: Dict[str, Any] = field(default_factory=dict)


@dataclass
class Outcome:
    """What a driver reports: the end-to-end values it measured, each
    compared number with its limit, the work attempted and failed, the
    device's peak memory, the traced sub-window's summary and the raw
    readings the per-layer readers take their numbers from."""
    end_to_end: Dict[str, float]
    checks: Dict[str, Tuple[float, float]]
    attempted: int
    failed: int
    memory_peak_bytes: int
    trace: Optional[Dict[str, Any]] = None
    readings: Dict[str, Any] = field(default_factory=dict)

    @property
    def correct(self) -> bool:
        return bool(self.checks) and all(
            math.isfinite(v) and v <= limit
            for v, limit in self.checks.values())


def _load_json(path: str) -> Dict[str, Any]:
    with open(path) as f:
        return json.load(f)


def _module(path: str, tag: str):
    if not os.path.isfile(path):
        raise FileNotFoundError(path)
    spec = importlib.util.spec_from_file_location(
        f"portbench_{tag}_" + re.sub(r"\W", "_", os.path.basename(path)),
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Bench:
    """The benchmark's files under ``pkg_dir`` and its ``BENCHMARK.json``."""

    def __init__(self, pkg_dir: str = PKG_DIR,
                 bench_json: Optional[str] = None):
        self.pkg_dir = pkg_dir
        self.bench_json = bench_json or os.path.join(
            os.path.dirname(pkg_dir), "BENCHMARK.json")
        self.doc = _load_json(self.bench_json)

    def _file(self, kind: str, name: str, ext: str) -> str:
        if not NAME_RE.match(name):
            raise ValueError(f"{kind} name {name!r} is not a valid name")
        return os.path.join(self.pkg_dir, kind, name + ext)

    def names(self, kind: str) -> List[str]:
        """The names of the files of ``kind`` (``configs``,
        ``workloads``, ``traffic``, ``drivers``, ``metrics``)."""
        ext = ".py" if kind in ("drivers", "metrics") else ".json"
        d = os.path.join(self.pkg_dir, kind)
        return sorted(f[:-len(ext)] for f in os.listdir(d)
                      if f.endswith(ext) and not f.startswith("_"))

    def cell(self, name: str) -> Dict[str, Any]:
        """The cell: its ``BENCHMARK.json`` entry (``config``,
        ``traffic``, ``chips``, ``why``) with its file's ``limits``."""
        entry = [w for w in self.doc["workloads"] if w["name"] == name]
        if len(entry) != 1:
            raise KeyError(f"cell {name!r} is not in {self.bench_json}")
        doc = _load_json(self._file("workloads", name, ".json"))
        return {**entry[0], "limits": doc["limits"]}

    def config(self, name: str) -> Dict[str, Any]:
        return _load_json(self._file("configs", name, ".json"))

    def traffic(self, name: str) -> Dict[str, Any]:
        return _load_json(self._file("traffic", name, ".json"))

    def driver(self, name: str):
        return _module(self._file("drivers", name, ".py"), "driver")

    def reader(self, name: str):
        return _module(self._file("metrics", name, ".py"), "metric")

    def end_to_end(self, cell: str) -> List[Dict[str, Any]]:
        """The end-to-end metrics the cell reports."""
        return [m for m in self.doc["end_to_end"]
                if "workloads" not in m or cell in m["workloads"]]

    def per_layer(self, cell: str) -> List[Dict[str, Any]]:
        """The per-layer metrics read in the cell's traced runs: those
        whose ``workloads`` list it."""
        return [m for m in self.doc["per_layer"] if cell in m["workloads"]]
