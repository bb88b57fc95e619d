#!/usr/bin/env python3
"""Time the all-pairs kernels of two checkouts of this repository on one
CUDA card, in turns (A, B, B, A), at ``chip_smoke.py`` phase 8's input.

    python3 tools/compare_all_pairs.py ROOT_A ROOT_B [--n-log2 16] [--reps 5]

Each turn is a process of its own with ``ROOT/src`` first on the path: it
builds that checkout's kernels into ``ROOT/build/`` and times its
``pairwise_count`` and ``pairwise_min_label`` wrappers with CUDA events on
the same input, made by this checkout's generator (2^n-log2 points in
d = 64 from 64 Gaussian clusters, eps the 1% quantile, core = counts >= 5,
seeds as in phase 8). Every turn must give the same counts and labels.
One JSON line per turn, then one with the card and each root's mean.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]


def turn(root: Path, n_log2: int, reps: int, seed: int) -> dict:
    sys.path.insert(0, str(root / "src"))
    sys.path.insert(1, str(HERE))
    import torch
    import chip_smoke as cs
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels import pairwise as kp

    _build.build_all()
    n = 1 << n_log2
    x_np = cs.gaussian_clusters(seed + 12, n)
    eps = cs.quantile_eps(x_np, 0.01, seed + 13)
    x = torch.from_numpy(x_np).to("cuda")
    ids = torch.arange(n, dtype=torch.int32, device="cuda")
    eps2 = ops.eps_squared(eps)
    counts = kp.pairwise_count(x, x, eps2)
    core = counts >= 5
    labels = kp.pairwise_min_label(x, x, ids, core, eps2)
    return {"root": str(root), "card": cs.card_identity(),
            "pairwise_count_ms": cs.cuda_ms(
                torch, lambda: kp.pairwise_count(x, x, eps2), reps),
            "pairwise_min_label_ms": cs.cuda_ms(
                torch, lambda: kp.pairwise_min_label(x, x, ids, core, eps2), reps),
            "counts_sum": int(counts.sum(dtype=torch.int64)),
            "labels_sum": int(labels.sum(dtype=torch.int64))}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("roots", nargs=2, type=Path)
    ap.add_argument("--n-log2", type=int, default=16)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--turn", type=Path, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.turn is not None:
        print(json.dumps(turn(args.turn.resolve(), args.n_log2, args.reps,
                              args.seed)), flush=True)
        return 0

    a, b = (r.resolve() for r in args.roots)
    runs = []
    for root in (a, b, b, a):
        out = subprocess.run(
            [sys.executable, __file__, *map(str, args.roots), "--turn", str(root),
             "--n-log2", str(args.n_log2), "--reps", str(args.reps),
             "--seed", str(args.seed)],
            capture_output=True, text=True, check=True, timeout=900)
        runs.append(json.loads(out.stdout.strip().splitlines()[-1]))
        print(json.dumps(runs[-1]), flush=True)
    if len({(r["counts_sum"], r["labels_sum"]) for r in runs}) != 1:
        print("compare_all_pairs: the turns disagree", file=sys.stderr)
        return 1
    mean = {}
    for root in (a, b):
        mine = [r for r in runs if r["root"] == str(root)]
        mean[str(root)] = {k: sum(r[k] for r in mine) / len(mine)
                           for k in ("pairwise_count_ms", "pairwise_min_label_ms")}
    print(json.dumps({"card": runs[0]["card"], "n": 1 << args.n_log2,
                      "mean_ms": mean}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
