#!/usr/bin/env python3
"""How full the grid DBSCAN's eps-cells get, and what a fixed capacity costs.

    python3 tools/grid_occupancy.py [--seed 0] [--n-log2 24]

Bins ``chip_smoke.py``'s clustered cloud (phase 4's generator) at the
paper's linking length and at 2^-8, and its uniform points (phase 7's) at
2^-8, into eps-cells of the unit cube. For each it prints the cells, the
largest cell, the slots ``(ncells + 1) * C`` with C the next power of two
of the largest cell, whether they pass the int32 slot ids, and the size
of ``cell_pts`` at 12 bytes a slot. A fixed capacity per cell holds a
density contrast of about C over the mean occupancy. Needs one CUDA card.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--n-log2", type=int, default=24)
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("grid_occupancy: no CUDA card", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from chip_smoke import card_identity, grid_eps, plummer_cloud, uniform_cube
    from repro_torch.data.pipeline import hacc_benchmark_epsilon

    n = 1 << args.n_log2
    eps = grid_eps(n)
    cloud = torch.from_numpy(plummer_cloud(args.seed, n)[0]).cuda()
    uniform = torch.from_numpy(uniform_cube(args.seed + 11, n)).cuda()
    print(card_identity())
    for what, p, e in (("Plummer cloud", cloud, hacc_benchmark_epsilon(1.0, n)),
                       ("Plummer cloud", cloud, eps), ("uniform", uniform, eps)):
        side = int(np.ceil(1.0 / e))
        c = torch.floor(p.double() / e).long().clamp(0, side - 1)
        largest = int(torch.unique((c[:, 0] * side + c[:, 1]) * side + c[:, 2],
                                   return_counts=True)[1].max())
        slots = (side ** 3 + 1) * (1 << (largest - 1).bit_length())
        print(f"{what} of {n} points in eps-cells of {e:.6g}: {side}^3 = "
              f"{side ** 3:.4g} cells, largest cell {largest}, slots (ncells + 1)"
              f" * C at the next power of two {slots:.3g} "
              f"({'past' if slots > 2**31 - 1 else 'within'} int32), cell_pts "
              f"{slots * 12 / 1e9:.4g} GB")
    return 0


if __name__ == "__main__":
    sys.exit(main())
