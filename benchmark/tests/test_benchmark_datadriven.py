"""A later change adds a configuration, a traffic mix, a cell and a
per-layer metric as new files and new entries, and the harness runs them
with no edit to any file it has."""

import json
import os
import shutil

from benchmark.tests.conftest import cpu_run, small_copy

READER = '''"""Steps per simulated hour (a test's metric)."""
LAYER = "period solver (solver/step.py stats)"
UNIT = "count/sim-h"
MOVES = "setup_s"
SOURCE = "program_counter"


def read(run):
    return sum(h["stats"][0] for h in run.hours) / len(run.hours)
'''


def test_a_new_cell_and_metric_are_found_by_name(tmp_path):
    root = small_copy(tmp_path, box=12)
    bench = os.path.join(root, "benchmark")
    shutil.copy(os.path.join(bench, "configs", "ravone768_water.json"),
                os.path.join(bench, "configs", "dummy_water.json"))
    with open(os.path.join(bench, "traffic", "short_storm.json"), "w") as f:
        json.dump({"name": "short_storm", "why": "ten minutes of the storm", "period_s": 600.0,
                   "psi0_m": -2.0, "rain_m_per_h": 0.02}, f)
    with open(os.path.join(bench, "metrics", "dummy_steps_per_sim_hour.py"), "w") as f:
        f.write(READER)
    path = os.path.join(root, "BENCHMARK.json")
    with open(path) as f:
        spec = json.load(f)
    spec["configs"].append(dict(spec["configs"][0], name="dummy_water",
                                file="benchmark/configs/dummy_water.json"))
    spec["workloads"].append({"name": "dummy_cell", "config": "dummy_water",
                              "traffic": "short_storm", "chips": 1, "why": "a test's cell"})
    spec["per_layer"].append({"name": "dummy_steps_per_sim_hour", "unit": "count/sim-h",
                              "better": "lower", "source": "program_counter",
                              "layer": "period solver (solver/step.py stats)",
                              "moves": "setup_s", "workloads": ["dummy_cell"]})
    with open(path, "w") as f:
        json.dump(spec, f)
    rc, result = cpu_run(root, "dummy_cell", trace=True)
    assert rc == 0 and result["correct"]
    assert result["metrics"]["dummy_steps_per_sim_hour"]["value"] > 0
    rc, result = cpu_run(root, "dummy_cell", trace=False)
    assert rc == 0 and set(result["metrics"]) == {"setup_s"}
