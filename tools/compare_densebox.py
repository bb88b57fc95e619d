#!/usr/bin/env python3
"""Time ``fdbscan_densebox`` and its two kernels in two checkouts of this
repository on one CUDA card, in turns (A, B, B, A), on ``chip_smoke.py``
phase 12's cloud.

    python3 tools/compare_densebox.py ROOT_A ROOT_B [--n-log2 24] [--reps 5]
    python3 tools/compare_densebox.py --warp-scan ROOT_B [...]

Each turn is a process of its own with ``ROOT/src`` first on the path: it
builds that checkout's kernels into ``ROOT/build/`` and, on the cloud of
phase 12 (``plummer_cloud``, same seed, eps at the paper's linking
length, min_pts 2):

* runs ``fdbscan_densebox`` twice and times the second (host clock to
  ``torch.cuda.synchronize()``) with its peak device memory, then a third
  time split by stage (``chip_smoke.densebox_stages``: grid, tree, count
  pass, union rounds, border pass; each stage between two synchronizes),
  and keeps the inputs of its DENSE_COUNT launch and of its first and
  last DENSE_MIN_LABEL launch (a union round and the border pass);
* times each of those three launches with CUDA events, inside
  ``shared_pack`` as ``fdbscan_densebox`` makes them.

Every turn must give the same labels, core mask and ``num_rounds`` and
the same three launch outputs (SHA-256 of their bytes). One JSON line per
turn, then one with the card and each root's means.

``--warp-scan ROOT_B`` compares ROOT_B with a copy of itself whose
DenseBox kernel scans a partial cell's run with the whole warp, one run
after another, a point a lane (``tools/densebox_warp_scan.cu`` spliced
into its ``csrc/wavefront.cu``, built under
``ROOT_B/build/variants/warp_scan``), the copy taking turn A.
"""
from __future__ import annotations

import argparse
import contextlib
import hashlib
import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
DEV = "cuda"
LAUNCHES = ("count", "union", "border")

# The warp-scan variant: `dense_kernel` replaced by the fragment that scans
# a partial cell's run with the whole warp.
WARP_SCAN = HERE / "tools" / "densebox_warp_scan.cu"
KERNEL_DOC = "// DenseBox's walk, one thread per query"
LAUNCH = "template <int EPI, int PRED, bool BOX_LEAF, bool STATS, typename Off>\nint launch("


def warp_scan_variant(root: Path) -> Path:
    """A copy of ``root``'s port under ``root/build/variants/warp_scan``
    whose DenseBox kernel scans a partial cell's run with the whole warp."""
    dst = root / "build" / "variants" / "warp_scan"
    if dst.exists():
        shutil.rmtree(dst)
    shutil.copytree(root / "src", dst / "src",
                    ignore=shutil.ignore_patterns("__pycache__"))
    cu = dst / "src" / "repro_torch" / "kernels" / "csrc" / "wavefront.cu"
    text = cu.read_text()
    if text.count(KERNEL_DOC) != 1 or text.count(LAUNCH) != 1:
        raise SystemExit(f"compare_densebox: {cu} has no one-thread DenseBox kernel")
    a, b = text.index(KERNEL_DOC), text.index(LAUNCH)
    cu.write_text(text[:a] + WARP_SCAN.read_text() + "\n" + text[b:])
    return dst


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
    from repro_torch.core import dbscan as td
    from repro_torch.data.pipeline import hacc_benchmark_epsilon
    from repro_torch.kernels import _build
    from repro_torch.kernels import wavefront as kw

    _build.build_all()
    n = 1 << n_log2
    pos, _, _ = cs.plummer_cloud(seed, n)
    pts = torch.from_numpy(pos).to(DEV)
    del pos
    eps = hacc_benchmark_epsilon(1.0, n)
    out = {"root": str(root), "card": cs.card_identity(), "n": n}

    for _ in range(2):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        res = td.fdbscan_densebox(pts, eps, 2, device=DEV)
        torch.cuda.synchronize()
        out["densebox_s"] = time.perf_counter() - t0
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    out["result"] = digest(res.labels, res.core_mask, res.num_rounds)
    out["num_rounds"] = int(res.num_rounds)
    del res

    count, labels, stages = [], [], {}
    with contextlib.ExitStack() as stack:
        stack.enter_context(cs.tap(td, "wavefront_dense_count", count))
        stack.enter_context(cs.tap(td, "wavefront_dense_min_label", labels, every=True))
        stack.enter_context(cs.densebox_stages(torch, td, stages))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        td.fdbscan_densebox(pts, eps, 2, device=DEV)
        torch.cuda.synchronize()
        out["staged_s"] = time.perf_counter() - t0
    out["stages"] = stages
    out["other_s"] = out["staged_s"] - sum(v for k, v in stages.items()
                                           if k != "union_calls")
    calls = {"count": (kw.wavefront_dense_count, count[0]),
             "union": (kw.wavefront_dense_min_label, labels[0]),
             "border": (kw.wavefront_dense_min_label, labels[-1])}
    out["tree_leaves"] = count[0][0][0].num_leaves
    del count, labels
    for name in LAUNCHES:
        fn, (args, kwargs, got) = calls[name]
        out[f"{name}_out"] = digest(got)
        with kw.shared_pack(args[0]):
            out[f"{name}_ms"] = cs.cuda_ms(torch, lambda: fn(*args, **kwargs), reps)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("roots", nargs="+", type=Path)
    ap.add_argument("--warp-scan", action="store_true",
                    help="compare the one root with its warp-scan variant")
    ap.add_argument("--n-log2", type=int, default=24)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--turn", type=Path, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.turn is not None:
        print(json.dumps(turn(args.turn.resolve(), args.n_log2, args.reps,
                              args.seed)), flush=True)
        return 0

    if args.warp_scan:
        if len(args.roots) != 1:
            ap.error("--warp-scan takes one root")
        b = args.roots[0].resolve()
        a = warp_scan_variant(b)
    elif len(args.roots) == 2:
        a, b = (r.resolve() for r in args.roots)
    else:
        ap.error("give two roots, or one with --warp-scan")
    runs = []
    for root in (a, b, b, a):
        out = subprocess.run(
            [sys.executable, __file__, str(root), "--turn", str(root),
             "--n-log2", str(args.n_log2), "--reps", str(args.reps),
             "--seed", str(args.seed)],
            capture_output=True, text=True, timeout=900)
        if out.returncode:
            print(f"compare_densebox: the turn of {root} failed:\n"
                  f"{out.stderr[-4000:]}", file=sys.stderr)
            return 1
        runs.append(json.loads(out.stdout.strip().splitlines()[-1]))
        print(json.dumps(runs[-1]), flush=True)
    keys = ["result", "num_rounds"] + [f"{k}_out" for k in LAUNCHES]
    if len({tuple(r[k] for k in keys) for r in runs}) != 1:
        print("compare_densebox: the turns disagree", file=sys.stderr)
        return 1
    mean = {}
    for root in (a, b):
        mine = [r for r in runs if r["root"] == str(root)]
        cols = ([f"{k}_ms" for k in LAUNCHES]
                + ["densebox_s", "staged_s", "other_s", "peak_gib"])
        mean[str(root)] = {k: sum(r[k] for r in mine) / len(mine) for k in cols}
        mean[str(root)]["stages"] = {
            k: sum(r["stages"][k] for r in mine) / len(mine) for k in mine[0]["stages"]}
        mean[str(root)]["tree_leaves"] = mine[0]["tree_leaves"]
    print(json.dumps({"card": runs[0]["card"], "n": 1 << args.n_log2,
                      "mean": mean}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
