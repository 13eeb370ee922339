"""Time the bundled-Jacobi kernels on the card: the tiled design at the
tile that ``plan_tiles`` picks and at other tiles, and the per-sweep
design, on one seeded system. Every tile is first held against the
per-sweep design (x and norm bit for bit).

    python3 -m criteria3d_tpu_torch.bench_jacobi [--shape 7 768 768] [-K 8]
        [--tiles 18x4 16x4 20x3]

Prints the card's name and power limit, then one JSON line per design:
``ms`` per bundle (CUDA events, median of batches), the modelled box-array
passes and bytes of device memory, and the rate those bytes give.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys


def cuda_ms(fn, reps: int, batches: int = 5, warmup: int = 3) -> float:
    """Time of one ``fn()`` on the card [ms]: CUDA events around a batch of
    ``reps`` back-to-back calls, divided by ``reps``; the median of
    ``batches`` batches."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(batches):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def bundle_inputs(shape, seed: int, device):
    """Seeded float32 system of the bundle's form: a masked box, diagonally
    dominant coefficients, zero where the neighbour is missing or outside."""
    import torch
    from criteria3d_tpu_torch.solver.shifts import LATERAL_OFFSETS, shift2d
    L, R, C = shape
    g = torch.Generator(device=device).manual_seed(seed)

    def u(lo, hi, *s):
        return lo + (hi - lo) * torch.rand(*s, generator=g, device=device)

    mask = (u(0, 1, L, R, C) < 0.9).float()
    mask_b = mask > 0
    b = u(-0.2, 0.2, L, R, C) * mask
    up_ok = torch.zeros_like(mask_b)
    up_ok[1:] = mask_b[1:] & mask_b[:-1]
    dn_ok = torch.zeros_like(mask_b)
    dn_ok[:-1] = mask_b[:-1] & mask_b[1:]
    c_up = u(0, 0.09, L, R, C) * up_ok
    c_down = u(0, 0.09, L, R, C) * dn_ok
    c_lat = torch.stack([u(0, 0.09, L, R, C) * (mask_b & shift2d(mask_b, di, dj, fill=False))
                         for (di, dj) in LATERAL_OFFSETS])
    x = u(-3, 3, L, R, C) * mask
    return b, c_up, c_down, c_lat.contiguous(), mask, x


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--shape", type=int, nargs=3, default=(7, 768, 768))
    ap.add_argument("-K", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--tiles", nargs="*", default=(),
                    help="more tiles to time, as TIxS (side x sweeps on chip)")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("bench_jacobi: no CUDA device", file=sys.stderr)
        return 2
    from criteria3d_tpu_torch.solver import jacobi_bundle as JB
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(card, flush=True)
    L, R, C = args.shape
    K = args.K
    inputs = bundle_inputs(tuple(args.shape), args.seed, "cuda")
    box_bytes = L * R * C * 4
    x_s, n_s = JB.jacobi_bundle_per_sweep(*inputs, K=K)
    plan = JB.plan_tiles(L, K)
    tiles = [plan] + [tuple(int(v) for v in t.split("x")) for t in args.tiles]
    ok = True
    for TI, S in dict.fromkeys(tiles):
        if ((TI + 2 * S - 2) ** 2 > JB.MAX_THREADS
                or JB.tile_smem(L, TI, S) > JB.SMEM_PER_BLOCK):
            print(f"# tile {TI}x{S} does not fit a block at L = {L}", flush=True)
            continue
        x_t, n_t = JB.jacobi_bundle_tiled(*inputs, K, 0, TI, S)
        same = bool(torch.equal(x_t, x_s) and torch.equal(n_t, n_s))
        ok &= same
        ms = cuda_ms(lambda: JB.jacobi_bundle_tiled(*inputs, K, 0, TI, S), reps=20)
        passes = JB.modelled_passes(K, TI, S)
        print(json.dumps({"design": "tiled", "tile": TI, "sweeps_on_chip": S,
                          "planned": (TI, S) == plan, "shape": [L, R, C], "K": K,
                          "variant": JB.tiled_variant(*inputs, K=K),
                          "smem_bytes": JB.tile_smem(L, TI, S),
                          "threads": (TI + 2 * S - 2) ** 2, "ms": ms,
                          "modelled_passes": passes,
                          "achieved_tb_s": passes * box_bytes / ms * 1e-9,
                          "equal_to_per_sweep": same}), flush=True)
    ms = cuda_ms(lambda: JB.jacobi_bundle_per_sweep(*inputs, K=K), reps=20)
    print(json.dumps({"design": "per_sweep", "shape": [L, R, C], "K": K, "ms": ms,
                      "modelled_passes": 14 * K,
                      "achieved_tb_s": 14 * K * box_bytes / ms * 1e-9}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
