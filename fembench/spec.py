"""Where the harness finds each part of a cell, by the names in
``BENCHMARK.json`` (at the root of the checkout, beside ``fembench/``):

* a configuration: the ``file`` that its entry in ``configs`` names;
* a traffic mix: ``fembench/traffic/<traffic>.json``, whose ``driver``
  names the solve: ``fembench/drivers/<driver>.py``;
* a configuration's mesh: ``fembench/meshes/<mesh.kind>.py``;
* a cell's correctness limits: ``fembench/limits/<workload>.json``;
* a metric's reader: ``fembench/metrics/<metric name>.py``, or, where
  there is none, ``fembench/metrics/<the name's part before its first
  dot>.py``: a quantity split by the end-to-end metric it moves
  (``device_idle_share.lbfgs``, ``device_idle_share.mg``) has one reader.

A later cell, configuration, traffic mix or metric is new files and new
entries; no file here needs an edit for it.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def load_json(path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def workload(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(bench: dict, name: str, root: Path = ROOT) -> dict:
    for c in bench["configs"]:
        if c["name"] == name:
            return load_json(root / c["file"])
    raise KeyError(f"no config {name!r} in BENCHMARK.json")


def traffic(name: str) -> dict:
    return load_json(HERE / "traffic" / f"{name}.json")


def limits(workload_name: str) -> dict:
    return load_json(HERE / "limits" / f"{workload_name}.json")


def module(kind: str, name: str):
    """``fembench/<kind>/<name>.py`` as a module (names may hold dots), or
    the module of the name's part before its first dot where ``name`` has
    no file of its own."""
    path = HERE / kind / f"{name}.py"
    if not path.is_file():
        path = HERE / kind / f"{name.split('.')[0]}.py"
    if not path.is_file():
        raise KeyError(f"no {kind} module for {name!r}")
    spec = importlib.util.spec_from_file_location(
        f"fembench.{kind}.{name.replace('.', '__')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metrics_for(bench: dict, workload_name: str, section: str) -> list:
    """The entries of ``section`` ("end_to_end" or "per_layer") that this
    workload reports: those without a ``workloads`` key, and those whose
    key lists it."""
    return [m for m in bench[section]
            if workload_name in m.get("workloads", [workload_name])]
