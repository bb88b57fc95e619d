#!/usr/bin/env python3
"""Build text variants of ``csrc/segment.cu`` (threads a block, rows a
thread) and time each one's sum (2^24 x 8) and max (2^24 x 1) on the halo
catalog's shape of ids (``chip_smoke.catalog_ids``), on one CUDA card in
one process.

    python3 tools/segment_variants.py [--n-log2 24] [--reps 20]

Each variant compiles with the flags of ``kernels/_build.py`` into
``build/segment_variants/<name>.so`` (all started together) and runs
through the wrapper's C interface with carry scratch sized for its own
block of rows. Every variant's maxima must equal the plain version bit for
bit and its sums lie within the summation-order bound of
``chip_smoke.sum_tolerance`` with the count column exact. The variants are
timed with CUDA events in two rounds, forward and backward. One JSON line
per variant (ptxas registers and spills of its D = 8 and D = 1 sum
instances, ms of each kernel, mean of the rounds), then the card.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(HERE / "src"))
sys.path.insert(1, str(HERE))
OUT = HERE / "build" / "segment_variants"
# name: (threads a block, rows a thread); the first is the committed one.
VARIANTS = {"t256_r8": (256, 8), "t128_r8": (128, 8), "t256_r4": (256, 4),
            "t512_r4": (512, 4), "t128_r16": (128, 16), "t256_r16": (256, 16)}


def variant_source(text: str, threads: int, rows: int) -> str:
    for name, value in (("kThreads", threads), ("kRows", rows)):
        text, k = re.subn(rf"constexpr int {name} = \d+;",
                          f"constexpr int {name} = {value};", text)
        if k != 1:
            raise SystemExit(f"csrc/segment.cu: no single {name} to vary")
    return text


def build(nvcc: str, flags) -> dict:
    from repro_torch.kernels import _build
    OUT.mkdir(parents=True, exist_ok=True)
    text = (_build.CSRC / "segment.cu").read_text()
    procs = {}
    for name, (threads, rows) in VARIANTS.items():
        src = OUT / f"{name}.cu"
        src.write_text(variant_source(text, threads, rows))
        procs[name] = subprocess.Popen(
            [nvcc, *flags, "-o", str(OUT / f"{name}.so"), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    logs = {}
    for name, proc in procs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(f"nvcc failed for {name}:\n{logs[name]}")
    return logs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n-log2", type=int, default=24)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--seed", type=int, default=3)
    args = ap.parse_args(argv)

    import numpy as np
    import torch
    import chip_smoke as cs
    from repro_torch.kernels import _build
    from repro_torch.kernels import segment as ks

    logs = build(_build._nvcc(), _build._NVCC_FLAGS)
    rows, segs = 1 << args.n_log2, 1 << 20
    ids, tail = cs.catalog_ids(args.seed, rows)
    ids = torch.from_numpy(ids).cuda()
    rng = np.random.default_rng(args.seed + 1)
    x8 = torch.from_numpy(rng.standard_normal((rows, 8), np.float32)).cuda()
    x8[:, 0] = 1.0
    x8[-tail:] = 0.0
    x1 = torch.from_numpy(rng.standard_normal((rows, 1), np.float32)).cuda()
    x1[-tail:] = -ks.SEG_NEG_BIG
    want8 = ks.segment_sum_sorted_plain(x8, ids, segs)
    tol8 = cs.sum_tolerance(torch, x8, ids, segs)
    want1 = ks.segment_max_sorted_plain(x1, ids, segs)
    stream = torch.cuda.current_stream().cuda_stream

    calls = {}
    for name, (threads, rows_a_thread) in VARIANTS.items():
        lib = ctypes.CDLL(str(OUT / f"{name}.so"))
        chunk = lib.segment_chunk_rows()
        assert chunk == threads * rows_a_thread
        recs = ks.carry_rows(rows, chunk)
        scratch = {d: (torch.empty((recs, d), device="cuda"),
                       torch.empty(recs, dtype=torch.int32, device="cuda"))
                   for d in (1, 8)}

        def call(fn, x, fill, lib=lib, recs=recs, scratch=scratch):
            f = getattr(lib, fn)
            f.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                          ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                          ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                          ctypes.c_void_p]
            out = torch.full((segs, x.shape[1]), fill, device="cuda")
            rv, ri = scratch[x.shape[1]]
            code = f(x.data_ptr(), ids.data_ptr(), rows, x.shape[1], segs, 1,
                     out.data_ptr(), rv.data_ptr(), ri.data_ptr(), recs, stream)
            if code:
                raise SystemExit(f"{name}: {fn} returned CUDA error {code}")
            return out

        got = call("segment_sum_sorted", x8, 0.0)
        ok = bool(((got - want8).abs() <= tol8).all()) and torch.equal(
            got[:, 0], want8[:, 0])
        ok = ok and torch.equal(call("segment_max_sorted", x1, -ks.SEG_NEG_BIG), want1)
        if not ok:
            raise SystemExit(f"{name}: results differ from the plain versions")
        calls[name] = (lambda c=call: c("segment_sum_sorted", x8, 0.0),
                       lambda c=call: c("segment_max_sorted", x1, -ks.SEG_NEG_BIG))

    times = {name: [] for name in VARIANTS}
    order = list(VARIANTS)
    for names in (order, order[::-1]):
        for name in names:
            times[name].append([cs.cuda_ms(torch, fn, args.reps) for fn in calls[name]])
    for name in VARIANTS:
        rep = cs.ptxas_report(logs[name])
        regs = {tag: rep[k] for tag, key in (("sum_d8", "ILi0ELi8ELb1E"),
                                             ("sum_d1", "ILi0ELi1ELb1E"))
                for k in rep if key in k}
        sum_ms = [t[0] for t in times[name]]
        max_ms = [t[1] for t in times[name]]
        print(json.dumps({"variant": name, "threads": VARIANTS[name][0],
                          "rows_a_thread": VARIANTS[name][1], "ptxas": regs,
                          "sum_ms": sum_ms, "max_ms": max_ms,
                          "sum_mean_ms": sum(sum_ms) / 2,
                          "max_mean_ms": sum(max_ms) / 2}), flush=True)
    print(json.dumps({"card": cs.card_identity()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
