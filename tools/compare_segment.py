#!/usr/bin/env python3
"""Time the segment kernels and the in-situ step of two checkouts of this
repository on one CUDA card, in turns (A, B, B, A), at ``chip_smoke.py``
phase 4's inputs.

    python3 tools/compare_segment.py ROOT_A ROOT_B [--n-log2 24] [--reps 20]

Each turn is a process of its own with ``ROOT/src`` first on the path: it
builds that checkout's kernels into ``ROOT/build/`` and, on the cloud of
this checkout's generator (phase 4: 2^n particles, seed 0):

* runs one in-situ step (``simulation_halo_stats``: ``fdbscan`` then
  ``halo_catalog``) twice, timing the second (host clock to
  ``torch.cuda.synchronize()``) with its peak device memory, and keeps the
  inputs and outputs of its ``segment_sum_sorted`` and
  ``segment_max_sorted`` calls;
* times both kernels on those inputs with CUDA events.

What must be exact is compared exactly (SHA-256 of the bytes): labels, core
mask, ``num_rounds``, the catalog's integer fields, the sums' count column
and the max. The max's input on the path (squared radii about each halo's
center of mass) depends on the sums, so each turn holds its path max
bit for bit against the plain version on that input, and the turns compare
the max of a column that does not (the sum's input column 7, |v|^2 of the
members) over the same ids. The other sum columns may differ between a
kernel that adds with atomics and one that adds in a fixed order; every
pair of turns must agree within 2 (m - 1) u sum|x| (two summation orders of
m terms, u = 2^-24), and the two turns of B must give the same bits. Each
turn saves its sums under ``build/compare_segment/``. One JSON line per
turn, then one with the card and each root's means.
"""
from __future__ import annotations

import argparse
import contextlib
import hashlib
import json
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
SAVED = HERE / "build" / "compare_segment"
DEV = "cuda"
TIMED = ("segment_sum_sorted", "segment_max_sorted")


def digest(*tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.contiguous().cpu().numpy().tobytes())
    return h.hexdigest()


def turn(root: Path, index: int, n_log2: int, reps: int, seed: int) -> dict:
    sys.path.insert(0, str(root / "src"))
    sys.path.insert(1, str(HERE))
    import torch
    import chip_smoke as cs
    from repro_torch.analysis import insitu
    from repro_torch.data.pipeline import hacc_benchmark_epsilon
    from repro_torch.halos import catalog
    from repro_torch.kernels import _build
    from repro_torch.kernels import segment as ks

    _build.build_all()
    n = 1 << n_log2
    cfg = insitu.InsituConfig(mode="simulation", cadence=1, min_pts=2,
                              halo_min_count=10, halo_capacity=1 << 20)
    pos, vel, _ = cs.plummer_cloud(seed, n)
    pts = torch.from_numpy(pos).to(DEV)
    vel_t = torch.from_numpy(vel).to(DEV)
    del pos, vel
    eps = hacc_benchmark_epsilon(1.0, n)
    out = {"root": str(root), "card": cs.card_identity()}

    for _ in range(2):
        res, cat = [], []
        calls = {name: [] for name in TIMED}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with contextlib.ExitStack() as stack:
            stack.enter_context(cs.tap(insitu, "fdbscan", res, keep_args=False))
            stack.enter_context(cs.tap(insitu, "halo_catalog", cat, keep_args=False))
            for name in TIMED:
                stack.enter_context(cs.tap(catalog, name, calls[name]))
            t0 = time.perf_counter()
            insitu.simulation_halo_stats(pts, vel_t, cfg, eps, device=DEV)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
    out["step_s"] = secs
    out["step_peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    r, c = res[0][2], cat[0][2]
    out["insitu"] = digest(r.labels, r.core_mask, r.num_rounds, c.num_halos,
                           c.overflow, c.root, c.count, c.particle_halo)
    out["num_rounds"] = int(r.num_rounds)
    del res, cat, r, c, pts, vel_t

    (data, seg, nseg), _, sums = calls["segment_sum_sorted"][0]
    out["count_column"] = digest(sums[:, 0])
    out["sum_bits"] = digest(sums)
    SAVED.mkdir(parents=True, exist_ok=True)
    torch.save({"sums": sums.cpu(), "tol": cs.sum_tolerance(torch, data, seg, nseg).cpu()},
               SAVED / f"turn{index}.pt")
    (r2, _, _), _, path_max = calls["segment_max_sorted"][0]
    if not torch.equal(path_max, ks.segment_max_sorted_plain(r2, seg, nseg)):
        raise SystemExit("segment_max_sorted differs from its plain version")
    out["max"] = digest(ks.segment_max_sorted(data[:, 7:8].contiguous(), seg, nseg))
    for name in TIMED:
        args = calls[name][0][0]
        fn = getattr(ks, name)
        out[f"{name}_ms"] = cs.cuda_ms(torch, lambda: fn(*args), reps)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("roots", nargs=2, type=Path)
    ap.add_argument("--n-log2", type=int, default=24)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--turn", type=Path, help=argparse.SUPPRESS)
    ap.add_argument("--index", type=int, default=0, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.turn is not None:
        print(json.dumps(turn(args.turn.resolve(), args.index, args.n_log2,
                              args.reps, args.seed)), flush=True)
        return 0

    import torch
    a, b = (r.resolve() for r in args.roots)
    runs = []
    for index, root in enumerate((a, b, b, a)):
        out = subprocess.run(
            [sys.executable, __file__, *map(str, args.roots), "--turn", str(root),
             "--index", str(index), "--n-log2", str(args.n_log2),
             "--reps", str(args.reps), "--seed", str(args.seed)],
            capture_output=True, text=True, timeout=900)
        if out.returncode:
            print(f"compare_segment: the turn of {root} failed:\n"
                  f"{out.stderr[-4000:]}", file=sys.stderr)
            return 1
        runs.append(json.loads(out.stdout.strip().splitlines()[-1]))
        print(json.dumps(runs[-1]), flush=True)
    keys = ["insitu", "num_rounds", "count_column", "max"]
    if len({tuple(r[k] for k in keys) for r in runs}) != 1:
        print("compare_segment: the turns disagree on exact outputs", file=sys.stderr)
        return 1
    if runs[1]["sum_bits"] != runs[2]["sum_bits"]:
        print("compare_segment: B's two turns gave other sums", file=sys.stderr)
        return 1
    saved = [torch.load(SAVED / f"turn{i}.pt") for i in range(4)]
    worst = 0.0
    for i in range(4):
        for j in range(i):
            diff = (saved[i]["sums"] - saved[j]["sums"]).abs()
            tol = saved[i]["tol"]
            if not bool((diff <= tol).all()):
                print(f"compare_segment: sums of turns {j} and {i} differ past "
                      f"the summation-order bound", file=sys.stderr)
                return 1
            worst = max(worst, (diff / tol.clamp(min=1e-30)).max().item())
    mean = {}
    for root in (a, b):
        mine = [r for r in runs if r["root"] == str(root)]
        mean[str(root)] = {k: sum(r[k] for r in mine) / len(mine)
                           for k in [f"{t}_ms" for t in TIMED]
                           + ["step_s", "step_peak_gib"]}
    print(json.dumps({"card": runs[0]["card"], "n": 1 << args.n_log2,
                      "sum_diff_over_bound": worst, "mean": mean}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
