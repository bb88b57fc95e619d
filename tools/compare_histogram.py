#!/usr/bin/env python3
"""Time ``pair_count_histogram`` and its HISTOGRAM launch in two checkouts
of this repository on one CUDA card, in turns (A, B, B, A), on
``chip_smoke.py`` phase 12's cloud.

    python3 tools/compare_histogram.py ROOT_A ROOT_B [--n-log2 24] [--reps 5]
    python3 tools/compare_histogram.py --variant ieee-bins ROOT_B [...]

Each turn is a process of its own with ``ROOT/src`` first on the path: it
builds that checkout's traversal kernels into ``ROOT/build/`` and, on the
cloud of phase 12 (``plummer_cloud``, same seed, r_max four times the
paper's linking length, 16 bins):

* runs ``pair_count_histogram`` twice and times the second (host clock
  to ``torch.cuda.synchronize()``), keeping the inputs of its
  ``wavefront_histogram`` call;
* times that call with CUDA events as the path makes it (``launch_ms``:
  the tree's pack, the thresholds prologue where the checkout has one,
  and the walk), and inside ``shared_pack`` with the pack made once
  (``walk_ms``); where the checkout has it, the prologue alone
  (``edges_ms``); and COUNT's walk of the same queries from the same
  start nodes (``count_ms``, pack shared), the walk without the bins.

Every turn must give the same bins (SHA-256 of their bytes). One JSON line
per turn, then one with the card and each root's means.

``--variant NAME ROOT_B`` compares ROOT_B with a copy of itself, built
under ``ROOT_B/build/variants/NAME``, whose private-bin walk bins a pair
otherwise (every variant exact), the copy taking turn A:

* ``ieee-bins``: by the IEEE square root and division (``distance_bin``),
  as the parent does; with the parent against ROOT_B it splits the gain
  between the private bins and the bin rule;
* ``count``: by counting the thresholds at or below d2 in shared memory
  (n_bins - 1 compares), with no first bin from ``rsqrtf``;
* ``binary-search``: by halving over the thresholds (4 dependent
  shared-memory loads for 16 bins);
* ``run``: as ROOT_B, but a thread keeps its current bin and a run length
  in registers and adds the run to its counter in shared memory only when
  the bin changes and at the end of its walk.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
DEV = "cuda"
N_BINS = 16

# The variants: lines of csrc/wavefront.cu and what replaces each.
BIN_LINE = "const int b = threshold_bin(d2, h.edges, e.n_bins, e.scale);"
INCREMENT = "\n        ++h.own[b * kThreads];"
WALK_START = "  const int first_leaf = t.n - 1;\n  int node = start ? __ldg(start + qi) : 0;\n"
WALK_END = "  if constexpr (STATS) {\n    int* s = e.stats + qi;"
VARIANTS = {
    "ieee-bins": [(BIN_LINE, "const int b = distance_bin(d2, e.r_max, e.n_bins);")],
    "count": [(BIN_LINE, """int b = 0;
#pragma unroll 4
        for (int k = 0; k < e.n_bins - 1; ++k) b += d2 >= h.edges[k];""")],
    "binary-search": [
        (WALK_START, WALK_START + """\
  int half = 1;
  while (2 * half < e.n_bins) half *= 2;
"""),
        (BIN_LINE, """int b = 0;
        for (int s = half; s > 0; s >>= 1) {
          if (b + s - 1 < e.n_bins - 1 && d2 >= h.edges[b + s - 1]) b += s;
        }""")],
    "run": [
        (WALK_START, WALK_START + """\
  int run_bin = 0;
  unsigned run_len = 0;
"""),
        (BIN_LINE + INCREMENT, BIN_LINE + """
        if (b != run_bin) {
          if (run_len) h.own[run_bin * kThreads] += run_len;
          run_bin = b;
          run_len = 0;
        }
        ++run_len;"""),
        (WALK_END, """  if constexpr (EPI == HISTOGRAM_PRIVATE) {
    if (run_len) h.own[run_bin * kThreads] += run_len;
  }
""" + WALK_END)],
}


def variant(root: Path, name: str) -> Path:
    """A copy of ``root``'s port under ``root/build/variants/<name>``
    with its kernel source's lines replaced as ``VARIANTS[name]`` says."""
    dst = root / "build" / "variants" / name
    if dst.exists():
        shutil.rmtree(dst)
    shutil.copytree(root / "src", dst / "src",
                    ignore=shutil.ignore_patterns("__pycache__"))
    cu = dst / "src" / "repro_torch" / "kernels" / "csrc" / "wavefront.cu"
    text = cu.read_text()
    for old, new in VARIANTS[name]:
        if text.count(old) != 1:
            raise SystemExit(f"compare_histogram: {cu} has no one {old!r}")
        text = text.replace(old, new)
    cu.write_text(text)
    return dst


def turn(root: Path, n_log2: int, reps: int, seed: int) -> dict:
    sys.path.insert(0, str(root / "src"))
    sys.path.insert(1, str(HERE))
    import torch
    import chip_smoke as cs
    from repro_torch.core import correlation as tc
    from repro_torch.data.pipeline import hacc_benchmark_epsilon
    from repro_torch.kernels import _build
    from repro_torch.kernels import wavefront as kw

    _build.build_all(("wavefront",))
    n = 1 << n_log2
    pos, _, _ = cs.plummer_cloud(seed, n)
    pts = torch.from_numpy(pos).to(DEV)
    del pos
    r_max = 4 * hacc_benchmark_epsilon(1.0, n)
    out = {"root": str(root), "card": cs.card_identity(), "n": n, "r_max": r_max,
           "n_bins": N_BINS}

    calls = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with cs.tap(tc, "wavefront_histogram", calls):
            hist = tc.pair_count_histogram(pts, r_max, N_BINS, device=DEV)
        torch.cuda.synchronize()
        out["histogram_s"] = time.perf_counter() - t0
    out["bins"] = hist.tolist()
    out["bins_sha256"] = hashlib.sha256(hist.cpu().numpy().tobytes()).hexdigest()
    args, kwargs, _ = calls[-1]
    del calls, hist, pts
    out["launch_ms"] = cs.cuda_ms(torch, lambda: kw.wavefront_histogram(*args, **kwargs),
                                  reps)
    with kw.shared_pack(args[0]):
        out["walk_ms"] = cs.cuda_ms(torch, lambda: kw.wavefront_histogram(*args, **kwargs),
                                    reps)
    if hasattr(kw, "histogram_edges"):
        out["edges_ms"] = cs.cuda_ms(torch, lambda: kw.histogram_edges(r_max, N_BINS, DEV),
                                     reps)
    bvh, centers, r2 = args[:3]
    with kw.shared_pack(bvh):
        out["count_ms"] = cs.cuda_ms(torch, lambda: kw.wavefront_count(
            bvh, centers, r2, start=kwargs["start"]), reps)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("roots", nargs="+", type=Path)
    ap.add_argument("--variant", choices=sorted(VARIANTS),
                    help="compare the one root with this variant of it")
    ap.add_argument("--n-log2", type=int, default=24)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--turn", type=Path, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.turn is not None:
        print(json.dumps(turn(args.turn.resolve(), args.n_log2, args.reps,
                              args.seed)), flush=True)
        return 0

    if args.variant:
        if len(args.roots) != 1:
            ap.error("--variant takes one root")
        b = args.roots[0].resolve()
        a = variant(b, args.variant)
    elif len(args.roots) == 2:
        a, b = (r.resolve() for r in args.roots)
    else:
        ap.error("give two roots, or one with --variant")
    runs = []
    for root in (a, b, b, a):
        out = subprocess.run(
            [sys.executable, __file__, str(root), "--turn", str(root),
             "--n-log2", str(args.n_log2), "--reps", str(args.reps),
             "--seed", str(args.seed)],
            capture_output=True, text=True, timeout=900)
        if out.returncode:
            print(f"compare_histogram: the turn of {root} failed:\n"
                  f"{out.stderr[-4000:]}", file=sys.stderr)
            return 1
        runs.append(json.loads(out.stdout.strip().splitlines()[-1]))
        print(json.dumps(runs[-1]), flush=True)
    if len({r["bins_sha256"] for r in runs}) != 1:
        print("compare_histogram: the turns disagree", file=sys.stderr)
        return 1
    mean = {}
    for root in (a, b):
        mine = [r for r in runs if r["root"] == str(root)]
        cols = [k for k in ("histogram_s", "launch_ms", "walk_ms", "edges_ms", "count_ms")
                if k in mine[0]]
        mean[str(root)] = {k: sum(r[k] for r in mine) / len(mine) for k in cols}
    print(json.dumps({"card": runs[0]["card"], "n": 1 << args.n_log2,
                      "pairs": sum(runs[0]["bins"]), "mean": mean}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
