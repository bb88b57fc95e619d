#!/usr/bin/env python3
"""Time the stencil kernels and the grid DBSCAN of two checkouts of this
repository on one CUDA card, in turns (A, B, B, A), at ``chip_smoke.py``
phase 7's inputs.

    python3 tools/compare_stencil.py ROOT_A ROOT_B [--n-log2 24] [--reps 5]

Each turn is a process of its own with ``ROOT/src`` first on the path: it
builds that checkout's kernels into ``ROOT/build/`` and, on the points of
this checkout's generator (2^n uniform points in the unit cube, eps the
mean spacing, ``min_pts = 5``, capacity 16):

* runs ``fdbscan_grid`` twice, timing the second (host clock to
  ``torch.cuda.synchronize()``), and keeps the inputs of its
  ``stencil_count`` launch and of its first ``stencil_min_label`` launch;
* times ``stencil_count`` and ``stencil_min_label`` on those inputs with
  CUDA events, each called alone, as a caller outside ``fdbscan_grid``
  calls it (where the wrapper makes a slot-class mask, one a call), and,
  where the checkout has ``shared_classes``, once more with the mask
  shared, as ``fdbscan_grid`` runs them.

Every turn must give the same kernel outputs and the same labels, core
mask and ``num_rounds`` (SHA-256 of their bytes). One JSON line per turn,
then one with the card and each root's means.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parents[1]
DEV = "cuda"
TIMED = ("stencil_count", "stencil_min_label")


def digest(*tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.contiguous().cpu().numpy().tobytes())
    return h.hexdigest()


def turn(root: Path, n_log2: int, reps: int, seed: int, capacity: int) -> dict:
    sys.path.insert(0, str(root / "src"))
    sys.path.insert(1, str(HERE))
    import torch
    import chip_smoke as cs
    from repro_torch.core import fdbscan_grid as tgrid
    from repro_torch.kernels import _build
    from repro_torch.kernels import ops
    from repro_torch.kernels import pairwise as kp

    _build.build_all()
    n = 1 << n_log2
    pts = torch.from_numpy(cs.uniform_cube(seed + 11, n)).to(DEV)
    eps = cs.grid_eps(n)
    lo = np.zeros(3, np.float32)
    dims = tgrid.grid_dims_for(lo, np.ones(3), eps)
    out = {"root": str(root), "card": cs.card_identity()}

    for _ in range(2):
        calls = {name: [] for name in TIMED}
        torch.cuda.synchronize()
        with cs.tap(ops, "cell_stencil_counts", calls["stencil_count"]), \
                cs.tap(ops, "cell_stencil_min_label", calls["stencil_min_label"]):
            t0 = time.perf_counter()
            res, ovf = tgrid.fdbscan_grid(pts, eps, cs.GRID_MIN_PTS, scene_lo=lo,
                                          grid_dims=dims, capacity=capacity,
                                          device=DEV)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
    if bool(ovf):
        raise SystemExit(f"capacity {capacity} overflows at n = {n}")
    out["fdbscan_grid_s"] = secs
    out["grid"] = digest(res.labels, res.core_mask, res.num_rounds)
    out["num_rounds"] = int(res.num_rounds)
    del res

    shared = getattr(kp, "shared_classes", None)
    for name in TIMED:
        (args, _, got) = calls[name][0]
        args = (*args[:-1], ops.eps_squared(args[-1]))
        fn = getattr(kp, name)
        out[f"{name}_out"] = digest(got)
        del got
        out[f"{name}_ms"] = cs.cuda_ms(torch, lambda: fn(*args), reps)
        if shared is not None:
            with shared(args[0]):
                out[f"{name}_shared_ms"] = cs.cuda_ms(torch, lambda: fn(*args), reps)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("roots", nargs=2, type=Path)
    ap.add_argument("--n-log2", type=int, default=24)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--capacity", type=int, default=16)
    ap.add_argument("--turn", type=Path, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.turn is not None:
        print(json.dumps(turn(args.turn.resolve(), args.n_log2, args.reps,
                              args.seed, args.capacity)), flush=True)
        return 0

    a, b = (r.resolve() for r in args.roots)
    runs = []
    for root in (a, b, b, a):
        out = subprocess.run(
            [sys.executable, __file__, *map(str, args.roots), "--turn", str(root),
             "--n-log2", str(args.n_log2), "--reps", str(args.reps),
             "--seed", str(args.seed), "--capacity", str(args.capacity)],
            capture_output=True, text=True, timeout=900)
        if out.returncode:
            print(f"compare_stencil: the turn of {root} failed:\n"
                  f"{out.stderr[-4000:]}", file=sys.stderr)
            return 1
        runs.append(json.loads(out.stdout.strip().splitlines()[-1]))
        print(json.dumps(runs[-1]), flush=True)
    keys = ["grid", "num_rounds"] + [f"{k}_out" for k in TIMED]
    if len({tuple(r[k] for k in keys) for r in runs}) != 1:
        print("compare_stencil: the turns disagree", file=sys.stderr)
        return 1
    mean = {}
    for root in (a, b):
        mine = [r for r in runs if r["root"] == str(root)]
        timed = [k for k in mine[0] if k.endswith("_ms") or k.endswith("_s")]
        mean[str(root)] = {k: sum(r[k] for r in mine) / len(mine) for k in timed}
    print(json.dumps({"card": runs[0]["card"], "n": 1 << args.n_log2,
                      "mean": mean}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
