"""What a cell is made of, found by name: its entry in ``BENCHMARK.json``,
its configuration file, its traffic file and the readers of its metrics.

Everything that belongs to one configuration, traffic mix or metric lives
in a file of its own under ``benchmark/``, so a later change adds a cell or
a metric by adding files and entries, never by editing the harness:

- ``benchmark/configs/<config>.json``: the deployment (grid, soil, layers,
  preset, soil heat) and the limits of the comparison;
- ``benchmark/traffic/<traffic>.json``: the forcing the period runs under;
- ``benchmark/metrics/<metric>.py``: a reader with ``LAYER``, ``UNIT``,
  ``MOVES``, ``SOURCE`` and ``read(run)``, returning the value or None
  when it finds nothing to read.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
from types import ModuleType

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@dataclasses.dataclass
class Cell:
    """One entry of ``workloads`` with its files read: ``end_to_end`` and
    ``per_layer`` the names of the metrics this cell reports."""
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list
    per_layer: list


def load_spec(root: str = ROOT) -> dict:
    """``BENCHMARK.json`` at ``root``."""
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def _json(root: str, *parts: str) -> dict:
    with open(os.path.join(root, "benchmark", *parts)) as f:
        return json.load(f)


def _reports(metric: dict, cell: str) -> bool:
    return cell in metric.get("workloads", [cell])


def cell(name: str, root: str = ROOT) -> Cell:
    """The cell ``name`` of ``root``'s ``BENCHMARK.json`` (``KeyError``
    when there is none): its configuration and traffic files and the
    metrics it reports. A per-layer metric without ``workloads`` is
    reported where its ``moves`` metric is."""
    spec = load_spec(root)
    entry = {w["name"]: w for w in spec["workloads"]}[name]
    e2e = [m["name"] for m in spec["end_to_end"] if _reports(m, name)]
    per_layer = [m["name"] for m in spec["per_layer"]
                 if (name in m["workloads"] if "workloads" in m else m["moves"] in e2e)]
    return Cell(name=name, chips=int(entry["chips"]),
                config=_json(root, "configs", entry["config"] + ".json"),
                traffic=_json(root, "traffic", entry["traffic"] + ".json"),
                end_to_end=e2e, per_layer=per_layer)


def reader(metric: str, root: str = ROOT) -> ModuleType:
    """The reader module of ``metric``: ``benchmark/metrics/<metric>.py``
    (loaded by path: a metric's name may hold dots)."""
    path = os.path.join(root, "benchmark", "metrics", metric + ".py")
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{metric}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module
