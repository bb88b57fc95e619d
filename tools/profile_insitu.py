#!/usr/bin/env python3
"""Where an in-situ analysis step's time goes on the card.

    python3 tools/profile_insitu.py [--seed 0] [--n-log2 24]

Builds the same 2^24-particle cloud as ``chip_smoke.py`` phase 4, runs one
warm-up analysis step, then one step under ``torch.profiler`` and prints:
the step's wall time, the device time per kernel (top 20), the summed
device time and the device's idle share of the step. Needs one CUDA card.
"""
from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--n-log2", type=int, default=24)
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("profile_insitu: no CUDA card", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from chip_smoke import card_identity, plummer_cloud
    from repro_torch.analysis.insitu import InsituAnalyzer, InsituConfig
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    n = 1 << args.n_log2
    pos, vel, _ = plummer_cloud(args.seed, n)
    params = {"positions": torch.from_numpy(pos).cuda(),
              "velocities": torch.from_numpy(vel).cuda()}
    analyzer = InsituAnalyzer(InsituConfig(
        mode="simulation", cadence=1, min_pts=2, halo_min_count=10,
        halo_capacity=1 << 20))
    analyzer.maybe_run(params, 0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        analyzer.maybe_run(params, 1)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or \
            getattr(e, "self_cuda_time_total", 0.0)

    # Device-side events only (kernels, copies, sets): the operator events
    # that launched them carry the same time again.
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and dev_us(e) > 0]
    events.sort(key=dev_us, reverse=True)
    busy = sum(dev_us(e) for e in events) / 1e6
    print(f"card: {card_identity()}")
    print(f"step wall {wall:.4f} s (profiled), device busy {busy:.4f} s, "
          f"idle share {1 - busy / wall:.3f}")
    for e in events[:20]:
        print(f"{dev_us(e) / 1e3:12.3f} ms  x{e.count:6d}  {e.key[:90]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
