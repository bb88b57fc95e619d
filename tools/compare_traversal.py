#!/usr/bin/env python3
"""Time the traversal kernels of two checkouts of this repository on one
CUDA card, in turns (A, B, B, A), at ``chip_smoke.py``'s inputs.

    python3 tools/compare_traversal.py ROOT_A ROOT_B [--n-log2 24] [--reps 5]

Each turn is a process of its own with ``ROOT/src`` first on the path: it
builds that checkout's kernels into ``ROOT/build/`` and, on clouds made by
this checkout's generator (phases 4 and 5 of ``chip_smoke.py``, same
seeds):

* runs one in-situ step (``simulation_halo_stats``: ``fdbscan`` then
  ``halo_catalog``) twice, timing the second (host clock to
  ``torch.cuda.synchronize()``) with its peak device memory, and keeps
  its COUNT and MIN_LABEL inputs (each wrapper's first call);
* times ``wavefront_count`` and ``wavefront_min_label`` on those inputs
  (phase 4's) and ``wavefront_fill`` (``query_csr``'s fill, exact
  capacity), ``wavefront_fixed`` (capacity 32, ``query_csr_buffered``'s
  first attempt) and ``wavefront_potential`` (every particle at 2 eps) on
  phase 5's, with CUDA events, each call as a caller outside ``fdbscan``
  makes it (where the tree is packed, a pack a call).

Every turn must give the same kernel outputs and the same labels, core
mask, ``num_rounds`` and catalog integers (SHA-256 of their bytes). One
JSON line per turn, then one with the card and each root's means.
"""
from __future__ import annotations

import argparse
import contextlib
import hashlib
import importlib
import json
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
DEV = "cuda"
TIMED = ("wavefront_count", "wavefront_min_label", "wavefront_fill",
         "wavefront_fixed", "wavefront_potential")


def digest(*tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.contiguous().cpu().numpy().tobytes())
    return h.hexdigest()


def turn(root: Path, n_log2: int, reps: int, seed: int) -> dict:
    sys.path.insert(0, str(root / "src"))
    sys.path.insert(1, str(HERE))
    import torch
    import chip_smoke as cs
    from repro_torch.analysis import insitu
    from repro_torch.core import dbscan
    tq = importlib.import_module("repro_torch.core.query")
    from repro_torch.core.bvh import build_bvh
    from repro_torch.core.geometry import scene_bounds
    from repro_torch.data.pipeline import hacc_benchmark_epsilon
    from repro_torch.kernels import _build
    from repro_torch.kernels import wavefront as kw

    _build.build_all()
    n, dev = 1 << n_log2, DEV
    cfg = insitu.InsituConfig(mode="simulation", cadence=1, min_pts=2,
                              halo_min_count=10, halo_capacity=1 << 20)
    pos, vel, _ = cs.plummer_cloud(seed, n)
    pts = torch.from_numpy(pos).to(dev)
    vel_t = torch.from_numpy(vel).to(dev)
    del pos, vel
    eps = hacc_benchmark_epsilon(1.0, n)
    out = {"root": str(root), "card": cs.card_identity()}

    for _ in range(2):
        res, cat, cnt, ml = [], [], [], []
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with contextlib.ExitStack() as stack:
            stack.enter_context(cs.tap(insitu, "fdbscan", res, keep_args=False))
            stack.enter_context(cs.tap(insitu, "halo_catalog", cat, keep_args=False))
            stack.enter_context(cs.tap(tq, "wavefront_count", cnt))
            stack.enter_context(cs.tap(dbscan, "wavefront_min_label", ml))
            t0 = time.perf_counter()
            insitu.simulation_halo_stats(pts, vel_t, cfg, eps, device=dev)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
    out["step_s"] = secs
    out["step_peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    r, c = res[0][2], cat[0][2]
    out["insitu"] = digest(r.labels, r.core_mask, r.num_rounds, c.num_halos,
                           c.overflow, c.root, c.count, c.particle_halo)
    out["num_rounds"] = int(r.num_rounds)
    del res, cat, r, c

    calls = {"wavefront_count": cnt[0][:2], "wavefront_min_label": ml[0][:2]}
    bvh = build_bvh(pts, *scene_bounds(pts))
    pred = tq.within(pts, eps)
    order = bvh.leaf_perm
    exact = tq.query_csr(bvh, pred, order=order)
    centers, r2 = pred.centers.contiguous(), tq.squared_radii(pred)
    calls["wavefront_fill"] = ((bvh, centers, r2, exact.offsets,
                                int(exact.total)), {"order": order})
    calls["wavefront_fixed"] = ((bvh, centers, r2, 32), {"order": order})
    # Every particle's potential at 2 eps, softened at eps / 100, as
    # ``most_bound_centers`` takes it for halo members.
    soft2 = float(torch.tensor(eps * 1e-2, dtype=torch.float32) ** 2)
    calls["wavefront_potential"] = ((bvh, centers, 4 * r2, soft2),
                                    {"order": order})
    del exact
    for name in TIMED:
        args, kwargs = calls[name]
        fn = getattr(kw, name)
        got = fn(*args, **kwargs)
        out[f"{name}_out"] = digest(*(got if isinstance(got, tuple) else (got,)))
        del got
        out[f"{name}_ms"] = cs.cuda_ms(torch, lambda: fn(*args, **kwargs), reps)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("roots", nargs=2, type=Path)
    ap.add_argument("--n-log2", type=int, default=24)
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
            capture_output=True, text=True, timeout=900)
        if out.returncode:
            print(f"compare_traversal: the turn of {root} failed:\n"
                  f"{out.stderr[-4000:]}", file=sys.stderr)
            return 1
        runs.append(json.loads(out.stdout.strip().splitlines()[-1]))
        print(json.dumps(runs[-1]), flush=True)
    keys = ["insitu", "num_rounds"] + [f"{k}_out" for k in TIMED]
    if len({tuple(r[k] for k in keys) for r in runs}) != 1:
        print("compare_traversal: the turns disagree", file=sys.stderr)
        return 1
    mean = {}
    for root in (a, b):
        mine = [r for r in runs if r["root"] == str(root)]
        mean[str(root)] = {k: sum(r[k] for r in mine) / len(mine)
                           for k in [f"{t}_ms" for t in TIMED]
                           + ["step_s", "step_peak_gib"]}
    print(json.dumps({"card": runs[0]["card"], "n": 1 << args.n_log2,
                      "mean": mean}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
