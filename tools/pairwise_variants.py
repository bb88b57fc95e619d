#!/usr/bin/env python3
"""Build variants of ``csrc/pairwise.cu`` on one CUDA card and report, for
each, ptxas's registers and spills of the all-pairs tile kernel and its
time at ``chip_smoke.py`` phase 8's input, with the SM clock and power
sampled while it runs.

    python3 tools/pairwise_variants.py [--only NAME ...]

A variant is the committed source with a few text substitutions (the
depth to which the feature loop is unrolled, how the copy addresses are
formed). Each is copied with the port under ``build/variants/<name>/``,
built there and run in a process of its own; each must equal the plain
versions at three shapes (3001 x 5003 x 64, 129 x 257 x 100 and the
split-candidate 300 x 70,000 x 64) and give the same counts and labels as
the others at 2^16 x 64. One JSON line per variant.
"""
from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
UNROLLED = """#pragma unroll 2
        for (int k = 0; k < kChunk; ++k) mac_feature(st, k, ty, tx, acc);"""


def unroll(depth: str):
    return UNROLLED, UNROLLED.replace("#pragma unroll 2", f"#pragma unroll {depth}".rstrip())


VARIANTS = {
    "unroll2": [],                       # the committed kernel
    "unroll4": [unroll("4")],
    "unroll16": [unroll("")],
    "addresses": [(  # copy addresses formed from the arguments at each copy
        """        cp_async16(&st.x[r0 + h][lane4], xsrc + (k0 + h) * a.mp);
        cp_async16(&st.y[r0 + h][lane4], ysrc + (k0 + h) * a.np + jt);""",
        """        cp_async16(&st.x[r0 + h][lane4], a.xt + (k0 + r0 + h) * a.mp + i0 + lane4);
        cp_async16(&st.y[r0 + h][lane4],
                   a.yt + (k0 + r0 + h) * a.np + j_lo + jt + lane4);""")],
}


def turn() -> dict:
    """Build and measure the port found at ``./src`` (a variant's copy)."""
    sys.path.insert(0, str(Path.cwd() / "src"))
    sys.path.insert(1, str(ROOT))
    import threading
    import time

    import numpy as np
    import torch
    import chip_smoke as cs
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels import pairwise as kp

    _build.build_all()
    ptxas = {("count" if "ILi0E" in k else "min_label"): v for k, v in
             cs.ptxas_report(_build.build_log("pairwise")).items()
             if "pairwise_tile_kernel" in k}
    rng = np.random.default_rng(1)
    exact = True
    for m, n, d in ((3001, 5003, 64), (129, 257, 100), (300, 70_000, 64)):
        x = torch.from_numpy(rng.random((m, d), dtype=np.float32)).cuda()
        y = torch.from_numpy(rng.random((n, d), dtype=np.float32)).cuda()
        eps2 = float(np.float32(0.35 * d ** 0.5) ** 2)
        lab = torch.from_numpy(rng.permutation(n).astype(np.int32)).cuda()
        cor = torch.from_numpy(rng.random(n) < 0.4).cuda()
        exact &= torch.equal(kp.pairwise_count(x, y, eps2),
                             kp.pairwise_count_plain(x, y, eps2))
        exact &= torch.equal(kp.pairwise_min_label(x, y, lab, cor, eps2),
                             kp.pairwise_min_label_plain(x, y, lab, cor, eps2))
    n = 1 << 16
    x_np = cs.gaussian_clusters(12, n)
    eps2 = ops.eps_squared(cs.quantile_eps(x_np, 0.01, 13))
    x = torch.from_numpy(x_np).cuda()
    ids = torch.arange(n, dtype=torch.int32, device="cuda")
    counts = kp.pairwise_count(x, x, eps2)
    core = counts >= 5
    labels = kp.pairwise_min_label(x, x, ids, core, eps2)

    samples, done = [], threading.Event()

    def sample():
        while not done.is_set():
            out = subprocess.run(
                ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
                 "--format=csv,noheader,nounits"],
                capture_output=True, text=True, timeout=60).stdout.split(",")
            samples.append((float(out[0]), float(out[1])))
            time.sleep(0.05)

    sampler = threading.Thread(target=sample)
    sampler.start()
    try:
        count_ms = cs.cuda_ms(torch, lambda: kp.pairwise_count(x, x, eps2), 20)
        min_ms = cs.cuda_ms(
            torch, lambda: kp.pairwise_min_label(x, x, ids, core, eps2), 20)
    finally:
        done.set()
        sampler.join(timeout=120)
    return {"exact": bool(exact), "ptxas": ptxas, "count_ms": count_ms,
            "min_label_ms": min_ms, "card": cs.card_identity(),
            "sm_mhz": [min(c for c, _ in samples), max(c for c, _ in samples)],
            "power_w": [min(p for _, p in samples), max(p for _, p in samples)],
            "counts_sum": int(counts.sum(dtype=torch.int64)),
            "labels_sum": int(labels.sum(dtype=torch.int64))}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", nargs="*", choices=sorted(VARIANTS))
    ap.add_argument("--turn", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.turn:
        print(json.dumps(turn()), flush=True)
        return 0

    src = (ROOT / "src/repro_torch/kernels/csrc/pairwise.cu").read_text()
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
        (vdir / "src/repro_torch/kernels/csrc/pairwise.cu").write_text(text)
        out = subprocess.run([sys.executable, __file__, "--turn"], cwd=vdir,
                             capture_output=True, text=True, check=True,
                             timeout=900)
        results[name] = json.loads(out.stdout.strip().splitlines()[-1])
        print(json.dumps({"variant": name, **results[name]}), flush=True)
    sums = {(r["counts_sum"], r["labels_sum"]) for r in results.values()}
    if len(sums) != 1 or not all(r["exact"] for r in results.values()):
        print("pairwise_variants: a variant is not exact", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
