"""Each cell rehearsed end to end at a small box on the CPU: set-up, a
window of one hour, the traced readings, the comparison with the
reference and the result line."""

import json

import pytest

from benchmark import harness, spec
from benchmark.tests.conftest import cpu_run, small_copy

CELLS = [w["name"] for w in spec.load_spec()["workloads"]]


@pytest.mark.parametrize("trace", [False, True], ids=["trace0", "trace1"])
@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_and_is_correct(tmp_path, cell, trace):
    root = small_copy(tmp_path, box=16)
    rc, result = cpu_run(root, cell, seed=2**31 + 5, trace=trace)
    assert rc == 0 and result["correct"], result
    c = spec.cell(cell, root)
    assert result["attempted"] == 1 and result["failed"] == 0
    expected = set(c.per_layer if trace else c.end_to_end)
    # off the card the device metrics and times are not measured
    assert set(result["metrics"]) <= expected
    if not trace:
        assert {"setup_s"} | {m for m in expected if m.startswith("s_per_sim_hour")} \
            <= set(result["metrics"])
    assert all(v["value"] <= v["limit"] for v in result["checks"].values())
    line = json.loads(harness.result_line(dict(result)))
    assert list(line)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(line)
