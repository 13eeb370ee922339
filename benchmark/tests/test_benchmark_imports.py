"""What the runs load, and the command's refusals: no module whose
top-level name is ``jax``, ``jaxlib``, ``flax`` or ``criteria3d_tpu``
(compared whole: ``criteria3d_tpu_torch`` is the port) in a run of the
harness, nothing of the port in the reference either; no result without a
card or without the port beside the benchmark."""

import json
import os
import subprocess
import sys

from benchmark.tests.conftest import REPO, small_copy

FORBIDDEN = {"jax", "jaxlib", "flax", "criteria3d_tpu"}


def _python(code: str, cwd: str, path: str | None = REPO):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    if path:
        env["PYTHONPATH"] = path
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=600)


def test_a_harness_run_loads_no_jax(tmp_path):
    root = small_copy(tmp_path / "root", box=12)
    out = _python(
        "import json, sys, time, torch\n"
        "from benchmark import harness\n"
        f"rc, res = harness.run('coupled_storm', 1, 0.0, True, time.time(), root={root!r}, "
        "device=torch.device('cpu'))\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n", cwd=REPO)
    assert out.returncode == 0, out.stderr[-3000:]
    top = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert not top & FORBIDDEN and "criteria3d_tpu_torch" in top


def test_the_reference_loads_nothing_of_the_port(tmp_path):
    root = small_copy(tmp_path / "root", box=12)
    out = _python(
        "import json, sys\n"
        "from benchmark import spec\n"
        "from benchmark.catchment import catchment_dem\n"
        "from benchmark.reference.storm import run_period\n"
        f"c = spec.cell('coupled_storm', {root!r})\n"
        "r = run_period(c.config, c.traffic, catchment_dem(c.config, 0), 'cpu')\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n", cwd=REPO)
    assert out.returncode == 0, out.stderr[-3000:]
    top = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert not top & (FORBIDDEN | {"criteria3d_tpu_torch"})


def test_the_harness_names_nothing_forbidden_in_its_sources():
    """Every ``import`` line under benchmark/ names its module whole; none
    is one of the forbidden names (the tests import the port, never JAX)."""
    for folder, _, files in os.walk(os.path.join(REPO, "benchmark")):
        for f in files:
            if not f.endswith(".py") or f == "test_benchmark_imports.py":
                continue
            with open(os.path.join(folder, f)) as fh:
                for line in fh:
                    words = line.split()
                    if len(words) >= 2 and words[0] in ("import", "from"):
                        assert words[1].split(".")[0] not in FORBIDDEN, (f, line)


def test_no_result_without_a_card():
    out = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", "water_storm",
                          "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=REPO,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode != 0 and out.stdout == ""


def test_no_result_from_the_benchmark_alone(tmp_path):
    """A directory with BENCHMARK.json and benchmark/ alone: no port, no
    result."""
    root = small_copy(tmp_path, box=12)
    out = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", "water_storm",
                          "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=root,
                         env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"},
                         capture_output=True, text=True, timeout=600)
    assert out.returncode != 0 and out.stdout == ""
