"""The benchmark's command:

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the cards the cell asks
for. It prints per-hour lines and the compared numbers on standard error
and one JSON object as the last line of standard output; it exits with
another code than 0, and prints no result, without a CUDA card, with fewer
cards than the cell asks for, or when JAX or the JAX package was loaded.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

_T_IMPORT = time.time()


def process_start() -> float:
    """The process's start on ``time.time()``'s clock, from /proc (this
    module's import time where /proc cannot say)."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as f:
            btime = next(int(line.split()[1]) for line in f if line.startswith("btime"))
        return btime + start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError, StopIteration):
        return _T_IMPORT


def cache_dirs(root: str) -> None:
    """Every kernel and build cache the run's libraries may keep, at fixed
    paths inside the checkout (the port builds its own libraries into
    ``criteria3d_tpu_torch/build``)."""
    base = os.path.join(root, ".bench_cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(base, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(base, "triton")


def main(argv=None) -> int:
    t_start = process_start()
    ap = argparse.ArgumentParser(prog="python3 -m benchmark.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    from benchmark import spec
    cache_dirs(spec.ROOT)
    from benchmark import harness
    rc, result = harness.run(args.workload, args.seed, args.seconds, bool(args.trace),
                             t_start)
    found = harness.forbidden_modules()
    if found:
        print(f"benchmark: forbidden modules loaded: {found}", file=sys.stderr)
        return 4
    if result is None:
        return rc or 1
    print(harness.result_line(result), flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
