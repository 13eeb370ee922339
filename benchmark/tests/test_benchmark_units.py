"""The benchmark's arithmetic on hand-made inputs: the window's rate, the
per-hour counts, busy unions and gaps, the roofline share, the comparison,
the DEM's orientations and the metric files' declarations against
BENCHMARK.json."""

import json
import os
import re
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from benchmark import check, harness, peaks, spec, trace
from benchmark.catchment import catchment_dem


def fake_run(walls, period_s=3600.0, **counts):
    system = SimpleNamespace(period_s=period_s)
    r = harness.Run(cell=None, system=system, on_card=True, power_limit="700.00 W")
    r.hours = [dict(wall_s=w, **{k: v[i] for k, v in counts.items()})
               for i, w in enumerate(walls)]
    r.window_s = sum(walls)
    return r


def test_window_rate_and_counts_by_hand():
    r = fake_run([2.0, 2.5, 1.5, 2.0],
                 host_reads=[2, 2, 3, 1], heat_sweeps=[10, 10, 10, 10],
                 stats=[[1, 2, 3, 500], [1, 2, 3, 520], [1, 2, 3, 540], [1, 2, 3, 560]])
    assert spec.reader("s_per_sim_hour").read(r) == 8.0 / 4
    assert spec.reader("host_reads_per_sim_hour").read(r) == 2.0
    assert spec.reader("inner_iters_per_sim_hour").read(r) == 530.0
    assert spec.reader("heat_sweeps_per_sim_hour").read(r) == 10.0
    r.peaks = [3 * 2**30]
    assert spec.reader("device_peak_gib").read(r) == 3.0
    r.capture_s = 0.5
    assert spec.reader("capture_s").read(r) == 0.5
    r.on_card = False
    assert spec.reader("device_peak_gib").read(r) is None
    assert spec.reader("capture_s").read(r) is None


PER_HOUR = ("s_per_sim_hour", "inner_iters_per_sim_hour", "host_reads_per_sim_hour",
            "heat_sweeps_per_sim_hour")


def test_readings_are_per_simulated_hour():
    """Over a 3,600 s period a reading is the window's per-period mean, bit
    for bit; over a 1,200 s period (three a simulated hour) three times
    it."""
    walls = [31.7, 32.9, 32.3]
    counts = dict(host_reads=[11, 11, 12], heat_sweeps=[1103, 1103, 1104],
                  stats=[[58, 59, 130, 170], [58, 59, 130, 171], [58, 59, 130, 169]])
    per_period = {"s_per_sim_hour": sum(walls) / 3,
                  "inner_iters_per_sim_hour": (170 + 171 + 169) / 3,
                  "host_reads_per_sim_hour": (11 + 11 + 12) / 3,
                  "heat_sweeps_per_sim_hour": (1103 + 1103 + 1104) / 3}
    hour = fake_run(walls, **counts)
    twenty = fake_run(walls, period_s=1200.0, **counts)
    assert hour.sim_hours == 3.0 and twenty.sim_hours == 1.0
    for name in PER_HOUR:
        rd = spec.reader(name)
        assert rd.read(hour) == per_period[name], name
        assert rd.read(twenty) == pytest.approx(3 * per_period[name], rel=1e-15), name


def test_a_mesh_cell_profiles_only_the_periods_first_minute(monkeypatch):
    """The profiled stretch of a traced run: the period's first ten
    minutes on one card, its first minute on a mesh (where the profiler
    slows the rounds' host enqueue), never past the period's end."""
    monkeypatch.setattr(harness, "read_profile",
                        lambda prof: dict(busy_s={}, device_ops=[], idle_gaps=[]))
    asked = []

    def hour(seconds=None):
        asked.append(seconds)
        return {"wall_s": 0.0}, None

    for mesh, period, stretch in ((None, 3600.0, 600.0), (None, 300.0, 300.0),
                                  ("2 x 2", 1200.0, 60.0), ("2 x 2", 30.0, 30.0)):
        system = SimpleNamespace(mesh=mesh, period_s=period, hour=hour)
        p = harness._profiled_stretch(system)
        assert asked[-1] == stretch and p["wall_s"] >= 0.0


def test_busy_union_and_gaps_by_hand():
    spans = [(0, 10), (5, 20), (30, 40), (100, 110)]
    assert trace.union_s(spans) == pytest.approx(40e-9)
    top = trace.gaps(spans, 2)
    assert [g[1:] for g in top] == [(40, 100), (20, 30)]
    assert [g[0] for g in top] == pytest.approx([60e-9, 10e-9])


def test_roofline_share_by_hand():
    share, bound = peaks.roofline_share(1e-3, 3.35e9, 1.0)
    assert bound == "bytes" and share == pytest.approx(100.0)
    share, bound = peaks.roofline_share(1e-3, 1.0, 6.7e9)
    assert bound == "flops" and share == pytest.approx(10.0)


def test_comparison_by_hand():
    mask = torch.zeros((2, 10, 10), dtype=torch.bool)
    mask[:, :, :5] = True              # 100 valid nodes
    zeros = torch.zeros(2, 10, 10, dtype=torch.float64)
    ref = dict(mask=mask, h=zeros, se=zeros, storage=50.0, mbr=1e-4, t=zeros,
               heat_sink=-200.0)
    prog = {k: (v.clone() if torch.is_tensor(v) else v) for k, v in ref.items()}
    prog["h"][1, 1, 8] = 5.0           # outside the mask: not compared
    prog["h"][1, 0, :2] = 0.25         # 2 of 100 nodes: the 99th is the larger
    prog["h"][0, 0, 0] = 0.125
    prog["se"][1, 2, 0] = 0.5          # 1 of 100: under the 99th percentile
    prog["t"][1, 0, 0] = 9.0           # the temperatures are not compared
    prog["storage"], prog["heat_sink"] = 50.5, -201.0
    assert check.p99(torch.arange(1.0, 101.0)) == 99.0
    g = check.gaps(prog, ref, 50.25)
    assert g == pytest.approx(dict(h_p99_m=0.25, se_p99=0.0, storage_gap_m3=0.25,
                                   heat_sink_rel=1.0 / 200))
    limits = dict(h_p99_m=0.3, se_p99=0.1, storage_gap_m3=0.5, heat_sink_rel=0.01)
    ok, table = check.judge(g, limits)
    assert ok and table["h_p99_m"] == {"value": 0.25, "limit": 0.3}
    assert not check.judge(g, dict(limits, storage_gap_m3=0.2))[0]
    assert not check.judge(dict(g, h_p99_m=float("nan")), limits)[0]
    assert not check.judge(g, dict(h_p99_m=1.0))[0]


def test_every_seed_runs_the_catalogued_catchment():
    from criteria3d_tpu_torch.problems import synthetic_catchment
    config = spec.cell("water_storm").config
    base = catchment_dem(config, 0)
    assert np.array_equal(base, synthetic_catchment(0))
    assert int((base > -9000).sum()) == 420836
    for seed in (0, 1, 7, -1, 2**31 + 11, 2**70):
        assert np.array_equal(catchment_dem(config, seed), base)


NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_metric_files_declare_what_benchmark_json_says():
    s = spec.load_spec()
    for m in s["end_to_end"]:
        rd = spec.reader(m["name"])
        assert (rd.UNIT, rd.SOURCE, rd.MOVES) == (m["unit"], m["source"], None)
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    e2e = {m["name"] for m in s["end_to_end"]}
    for m in s["per_layer"]:
        rd = spec.reader(m["name"])
        assert (rd.LAYER, rd.UNIT, rd.MOVES, rd.SOURCE) == (
            m["layer"], m["unit"], m["moves"], m["source"])
        assert m["moves"] in e2e
        for cell in m["workloads"]:
            assert m["moves"] in spec.cell(cell).end_to_end
    for w in s["workloads"]:
        c = spec.cell(w["name"])
        assert "setup_s" in c.end_to_end and len(c.end_to_end) >= 2 and c.per_layer
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in s[k]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    assert sum(w["chips"] == 4 for w in s["workloads"]) <= max(1, len(s["workloads"]) // 4)


def test_config_files_match_benchmark_json():
    s = spec.load_spec()
    for c in s["configs"]:
        with open(os.path.join(spec.ROOT, c["file"])) as f:
            cfg = json.load(f)
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
        assert c["file"].startswith("benchmark/configs/")
        assert set(cfg["limits"]) == set(check.WATER + (check.HEAT if cfg["heat"] else ()))
    for w in s["workloads"]:
        assert os.path.exists(os.path.join(spec.ROOT, "benchmark", "traffic",
                                           w["traffic"] + ".json"))


def test_roofline_bytes_by_hand(tmp_path):
    """Each call's bytes against a hand count from the box's shapes: B box
    nodes, P plane cells."""
    from benchmark.roofline import assemble_fast, cg_iteration, heat_sweep
    from benchmark.system import System
    from benchmark.tests.conftest import small_copy
    root = small_copy(tmp_path, box=12)
    coupled = spec.cell("coupled_storm", root)
    system = System(coupled.config, coupled.traffic,
                    catchment_dem(coupled.config, 1), torch.device("cpu"))
    L, R, C = system.shape
    B, P = L * R * C, R * C
    a = assemble_fast.prepare(system)
    # psi, psi_old, se, 3 grid boxes, 10 soil boxes in float32; the float64
    # sink; int8 types; bool mask | roughness f32, 8 + 8 planes f32, the
    # float64 pond | lat_area, vert_dist f32 and f64 (L each), lat_dist2d (8)
    assert a.read_bytes == (16 * 4 + 8 + 1 + 1) * B + (4 + 64 + 8) * P + (4 + 4 + 8) * L + 8 * 4
    # b, c_up, c_down, diag, 8 c_lat, water flow, boundary rate, k
    assert a.write_bytes == 15 * 4 * B
    assert a.flops == assemble_fast.FLOPS_PER_NODE * B
    g = cg_iteration.prepare(system)
    assert g.read_bytes == (1 + 14 * 4) * B and g.write_bytes == 3 * 4 * B
    h = heat_sweep.prepare(system)
    # b, c_up, c_down, 8 c_lat and x in float32, the bool heat mask
    assert h.read_bytes == (12 * 4 + 1) * B and h.write_bytes == 4 * B
    for c in (a, g, h):
        c.fn()
