"""Where the float64 snow pack of a project parts between runs: the JAX
package jitted, the JAX package op by op (``jax.disable_jit()``) and the
port, over hours 6-8 of the project of tests/test_torch_project.py
(``problems.write_project(n=16, seed=0, n_stations=6)``), on the CPU.

    JAX_PLATFORMS=cpu python -m tests.snow_split

For each hour and each pair of runs it prints the largest SWE difference
[mm] and the cells that differ by more than 1e-6 mm; for the cells where
the two JAX runs part, their internal energy [kJ m-2] before and after
the step in each run: the snow step's ``internal_energy <= EPSILON``
branch (physics/snow.py) keeps or melts the pack there. It takes about
three minutes (the op-by-op run most of it).
"""

import datetime
import sys
import tempfile

import jax
import numpy as np
import torch

from criteria3d_tpu.constants import EPSILON
from criteria3d_tpu.project import Criteria3DProject as JProject
from criteria3d_tpu_torch import problems
from criteria3d_tpu_torch.project import Criteria3DProject as TProject

HOURS = (6, 7, 8)


def snow_series(run_hour, model) -> dict:
    """SWE and internal energy after each of HOURS, as numpy arrays."""
    out = {}
    day = datetime.datetime(*problems.PROJECT_DATE)
    for hour in HOURS:
        run_hour(day + datetime.timedelta(hours=hour))
        snow = model().snow
        out[hour] = {f: np.array(getattr(snow, f)) for f in ("swe", "internal_energy")}
    return out


def main() -> int:
    torch.set_num_threads(1)
    with tempfile.TemporaryDirectory() as d:
        ini = problems.write_project(d, n=16, seed=0, n_stations=6)
        runs = {}
        for name in ("jit", "opbyop"):
            jp = JProject.load(ini, output_dir=f"{d}/{name}")
            jp.initialize()

            def hour(when, jp=jp, name=name):
                if name == "opbyop":
                    with jax.disable_jit():
                        jp.run_hour(when, write_outputs=False)
                else:
                    jp.run_hour(when, write_outputs=False)
            runs[name] = snow_series(hour, lambda jp=jp: jp.model)
        tp = TProject.load(ini, output_dir=f"{d}/port")
        tp.initialize(device="cpu")
        runs["port"] = snow_series(lambda when: tp.run_hour(when, write_outputs=False),
                                   lambda: tp.model)
    for hour in HOURS:
        for a, b in (("jit", "opbyop"), ("port", "opbyop"), ("port", "jit")):
            d_swe = np.abs(runs[a][hour]["swe"] - runs[b][hour]["swe"])
            cells = np.argwhere(d_swe > 1e-6)
            print(f"{hour} h {a} vs {b}: max |dSWE| {d_swe.max()} mm, "
                  f"{len(cells)} cells apart by > 1e-6 mm", flush=True)
    split = np.argwhere(np.abs(runs["jit"][8]["swe"] - runs["opbyop"][8]["swe"]) > 1e-6)
    for r, c in split:
        vals = {name: (runs[name][7]["internal_energy"][r, c],
                       runs[name][8]["internal_energy"][r, c],
                       runs[name][8]["swe"][r, c]) for name in runs}
        print(f"cell ({r}, {c}): internal energy at 7 h, at 8 h and SWE at 8 h "
              f"(EPSILON {EPSILON}): {vals}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
