"""A copy of the benchmark at a small box, for runs on the CPU: the
configurations cut to ``box`` cells a side (the disc's radius 0.45 of it)
and, where asked, the traffic's period shortened. Nothing here imports
JAX."""

import json
import os
import shutil
import time

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def small_copy(dst, box: int = 16, period_s: float | None = None) -> str:
    """``dst`` holding ``BENCHMARK.json`` and ``benchmark/`` with every
    configuration cut to ``box`` (and the traffic to ``period_s``)."""
    dst = str(dst)
    shutil.copytree(os.path.join(REPO, "benchmark"), os.path.join(dst, "benchmark"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), dst)
    for sub, edit in (("configs", dict(box=box, disc_radius_cells=box * 0.45)),
                      ("traffic", {} if period_s is None else dict(period_s=period_s))):
        folder = os.path.join(dst, "benchmark", sub)
        for f in os.listdir(folder):
            with open(os.path.join(folder, f)) as fh:
                obj = json.load(fh)
            obj.update(edit)
            with open(os.path.join(folder, f), "w") as fh:
                json.dump(obj, fh)
    return dst


def cpu_run(root: str, cell: str, seed: int = 3, trace: bool = False):
    """One run of ``cell`` under ``root`` on the CPU: ``(exit code, result)``
    (a window of one hour)."""
    from benchmark import harness
    return harness.run(cell, seed, 0.0, trace, time.time(), root=root,
                       device=torch.device("cpu"))


@pytest.fixture
def small_root(tmp_path):
    return small_copy(tmp_path)
