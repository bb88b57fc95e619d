#!/usr/bin/env python3
"""Build variants of ``csrc/wavefront.cu`` on one CUDA card and time, for
each, the COUNT (no early exit) and MIN_LABEL traversals of a 2^24-point
self-join, to see what bounds the kernel.

    python3 tools/wavefront_variants.py [--only NAME ...] [--n-log2 24]

A variant is the committed source with a few text substitutions: the
block size, or (with blocks of 128 threads) a cap on the warps an SM
holds, set by giving each block dynamic shared memory it does not use,
with the L1/shared split fixed at 64 KB of shared memory (so L1 keeps the
same size in every capped variant; "l1_192k" is the uncapped kernel at
that split). If the kernel
waits on the latency of its dependent loads, fewer warps in flight take
longer in proportion; if it waits on a shared unit (L1, L2), they do not.

Each variant is copied with the port under ``build/variants/<name>/``,
built there and run in a process of its own, on ``chip_smoke.py`` phase
4's cloud (same seed, eps at the paper's linking length), queries taken
in leaf order as ``fdbscan`` takes them, the tree packed once
(``shared_pack``). Every variant must give the same counts and labels.
One JSON line per variant, with the card's name and power limit.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
LAUNCH = ("wavefront_kernel<EPI, PRED, BOX_LEAF, Off, STATS>"
          "<<<blocks, kThreads, 0, stream>>>")


def threads(n: int, min_blocks: int):
    return [("constexpr int kThreads = 512;", f"constexpr int kThreads = {n};"),
            ("constexpr int kMinBlocks = 3;",
             f"constexpr int kMinBlocks = {min_blocks};")]


def warps_cap(warps: int | None):
    """Blocks of 128 threads, at most ``warps`` warps on an SM, and the
    shared memory carveout at 64 KB of the SM's 228 KB."""
    blocks = (warps or 64) // 4
    smem = 0 if warps is None else 64 * 1024 // blocks - 1024
    return threads(128, 12) + [(
        LAUNCH, "cudaFuncSetAttribute("
        "wavefront_kernel<EPI, PRED, BOX_LEAF, Off, STATS>, "
        "cudaFuncAttributePreferredSharedMemoryCarveout, 28);\n  "
        + LAUNCH.replace(", 0, stream", f", {smem}, stream"))]


VARIANTS = {
    "base": [],                          # the committed kernel: 512 threads
    "threads64": threads(64, 24),
    "threads128": threads(128, 12),
    "threads256": threads(256, 6),
    "threads1024": threads(1024, 2),
    "l1_192k": warps_cap(None),
    "warps32": warps_cap(32),
    "warps16": warps_cap(16),
    "warps8": warps_cap(8),
}


def turn(n_log2: int, reps: int) -> dict:
    """Build and measure the port found at ``./src`` (a variant's copy)."""
    sys.path.insert(0, str(Path.cwd() / "src"))
    sys.path.insert(1, str(ROOT))
    import numpy as np
    import torch
    import chip_smoke as cs
    from repro_torch.core.bvh import build_bvh
    from repro_torch.core.geometry import scene_bounds
    from repro_torch.data.pipeline import hacc_benchmark_epsilon
    from repro_torch.kernels import _build
    from repro_torch.kernels import wavefront as kw

    _build.build_all()
    ptxas = cs.ptxas_report(_build.build_log("wavefront"))
    registers = {name: v["registers"] for name, tag in cs.WAVEFRONT_KERNELS.items()
                 for k, v in ptxas.items() if tag in k}
    n = 1 << n_log2
    pos, _, _ = cs.plummer_cloud(0, n)
    pts = torch.from_numpy(pos).cuda()
    bvh = build_bvh(pts, *scene_bounds(pts))
    r2 = torch.full((n,), hacc_benchmark_epsilon(1.0, n), device="cuda") ** 2
    order = bvh.leaf_perm
    labels = torch.from_numpy(
        np.random.default_rng(2).permutation(n).astype(np.int32)).cuda()
    with kw.shared_pack(bvh):
        counts = kw.wavefront_count(bvh, pts, r2, order=order)
        core = counts >= 2
        best = kw.wavefront_min_label(bvh, pts, r2, labels, core, core, n,
                                      order=order)
        count_ms = cs.cuda_ms(torch, lambda: kw.wavefront_count(
            bvh, pts, r2, order=order), reps)
        min_ms = cs.cuda_ms(torch, lambda: kw.wavefront_min_label(
            bvh, pts, r2, labels, core, core, n, order=order), reps)
    digest = hashlib.sha256(counts.cpu().numpy().tobytes()
                            + best.cpu().numpy().tobytes()).hexdigest()
    return {"registers": registers, "count_ms": count_ms, "min_label_ms": min_ms,
            "card": cs.card_identity(), "digest": digest}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", nargs="*", choices=sorted(VARIANTS))
    ap.add_argument("--n-log2", type=int, default=24)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--turn", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.turn:
        print(json.dumps(turn(args.n_log2, args.reps)), flush=True)
        return 0

    src = (ROOT / "src/repro_torch/kernels/csrc/wavefront.cu").read_text()
    results = {}
    for name in args.only or VARIANTS:
        text = src
        for old, new in VARIANTS[name]:
            if text.count(old) != 1:
                raise SystemExit(f"variant {name}: its substitution does not "
                                 f"match the source once")
            text = text.replace(old, new)
        vdir = ROOT / "build" / "variants" / name
        shutil.rmtree(vdir, ignore_errors=True)
        shutil.copytree(ROOT / "src" / "repro_torch", vdir / "src" / "repro_torch",
                        ignore=shutil.ignore_patterns("__pycache__"))
        (vdir / "src/repro_torch/kernels/csrc/wavefront.cu").write_text(text)
        out = subprocess.run([sys.executable, __file__, "--turn", "--n-log2",
                              str(args.n_log2), "--reps", str(args.reps)],
                             cwd=vdir, capture_output=True, text=True,
                             timeout=900)
        if out.returncode:
            print(f"wavefront_variants: {name} failed:\n{out.stderr[-4000:]}",
                  file=sys.stderr)
            return 1
        results[name] = json.loads(out.stdout.strip().splitlines()[-1])
        print(json.dumps({"variant": name, **results[name]}), flush=True)
    if len({r["digest"] for r in results.values()}) != 1:
        print("wavefront_variants: the variants disagree", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
