"""Alternated timing of the bench's coupled and mesh legs in two checkouts, on the card.

    python -m criteria3d_tpu_torch.ab_legs OTHER_ROOT [--pairs 10] [--seed 0]
        [--n 768] [--device cuda]

OTHER_ROOT is the root of another checkout (for example the parent commit
unpacked with ``git archive``). Each process runs one checkout's coupled
leg (``bench.coupled_leg``, one run) and mesh leg (``bench.mesh_leg``, the
bundle hour on a (1, 1) mesh, bench.py's sampling) on
``problems.synthetic_catchment(seed)`` (the n x n box, 768 at full size;
``--device cpu`` with a small ``--n`` rehearses it), and prints one JSON line
(its walls, host reads and stats). The processes alternate in the order
other, this, this, other, ... until each checkout has run ``pairs`` times;
the last line gives each leg's per-process medians per checkout, the median
of those and this checkout's median over the other's. Each leg runs under
whichever driver each checkout gives it on the card (its ``driver`` is in
the line).
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

__all__ = ["run_one", "main"]

THIS_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# one process: the two legs of the checkout at sys.argv[1]
_CHILD = r"""
import json, statistics, sys
sys.path.insert(0, sys.argv[1])
from criteria3d_tpu_torch import SolverParameters, bench
from criteria3d_tpu_torch.problems import catchment_grid, synthetic_catchment
n = int(sys.argv[3])
grid = catchment_grid(synthetic_catchment(int(sys.argv[2]), n=n, radius=n * 366.0 / 768),
                      4.0, sys.argv[4])
cp = bench.coupled_leg(grid, SolverParameters.fast_f32(), {}, max_runs=1)
ml = bench.mesh_leg(grid)
print(json.dumps({
    "root": sys.argv[1],
    "coupled": {"walls": cp["runs_s"], "wall": statistics.median(cp["runs_s"]),
                "reads": cp["host_reads"], "counts": cp["counts"], "mbr": cp["mbr"],
                "driver": cp.get("driver")},
    "mesh": {"walls": ml["runs_s"], "wall": statistics.median(ml["runs_s"]),
             "reads": ml["host_reads"], "stats": list(ml["stats"]), "mbr": ml["mbr"],
             "driver": ml.get("driver")},
}))
"""


def run_one(root: str, seed: int, n: int = 768, device: str = "cuda") -> dict:
    """One process of ``root``'s checkout: its JSON line as a dict."""
    out = subprocess.run([sys.executable, "-c", _CHILD, root, str(seed), str(n), device],
                         check=True, capture_output=True, text=True, cwd=root)
    return json.loads(out.stdout.strip().splitlines()[-1])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("other", help="the root of the other checkout")
    ap.add_argument("--pairs", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--n", type=int, default=768)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    other = os.path.abspath(args.other)
    order = [(other, THIS_ROOT), (THIS_ROOT, other)]
    walls = {root: {"coupled": [], "mesh": []} for root in (other, THIS_ROOT)}
    for k in range(args.pairs):
        for root in order[k % 2]:
            line = run_one(root, args.seed, args.n, args.device)
            print(json.dumps(line), flush=True)
            for leg in ("coupled", "mesh"):
                walls[root][leg].append(line[leg]["wall"])
    summary = {}
    for leg in ("coupled", "mesh"):
        med = {name: statistics.median(walls[root][leg])
               for name, root in (("other", other), ("this", THIS_ROOT))}
        summary[leg] = {"other_walls": walls[other][leg], "this_walls": walls[THIS_ROOT][leg],
                        "other_median": med["other"], "this_median": med["this"],
                        "this_over_other": med["this"] / med["other"]}
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
