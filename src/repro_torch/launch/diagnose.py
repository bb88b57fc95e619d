"""Per-cell diagnostics of the dry run; port of ``repro/launch/diagnose.py``:

  PYTHONPATH=src python -m repro_torch.launch.diagnose --arch qwen3-moe-235b-a22b \\
      --shape train_4k [--mesh single] [--sp] [--top 12]

Prints the memory model of one cell and the top ops of its step by FLOPs
and by traffic, as ``op_cost`` counts them on ``meta`` (in place of the
reference's top collectives: the port models no collective).
"""
from __future__ import annotations

import argparse
import json
import sys


def main(argv=None) -> int:
    from repro_torch.configs import ARCH_IDS, SHAPES, get_config
    from repro_torch.launch import dryrun as dr
    from repro_torch.launch.mesh import make_production_mesh

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, required=True)
    ap.add_argument("--shape", choices=tuple(SHAPES), required=True)
    ap.add_argument("--mesh", choices=("single", "multi"), default="single")
    ap.add_argument("--sp", action="store_true")
    ap.add_argument("--top", type=int, default=12)
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    shape = SHAPES[args.shape]
    mesh = make_production_mesh(multi_pod=args.mesh == "multi")
    n = mesh.size
    dr._set_constraints(mesh, shape, args.sp, cfg)
    res = dr.count_cell(cfg, shape, mesh, top_k=args.top)
    mm = dr.memory_model(cfg, shape, mesh)
    dr._set_constraints(mesh, shape, False)

    print("memory model (GB):", json.dumps(
        {k: round(v / 1e9, 3) if isinstance(v, float) else v
         for k, v in mm.items()}, indent=1))
    print(f"flops/dev: {res['flops'] / n / 1e12:.1f} T   "
          f"traffic/dev: {res['traffic'] / n / 1e9:.1f} GB   "
          f"ops dispatched: {res['ops']}")
    for key, what in (("top_flops", "FLOPs"), ("top_traffic", "traffic")):
        print(f"top ops by {what} (whole step, per device):")
        for item in res[key]:
            print(f"  {item['flops'] / n / 1e9:12.3f} GFLOP {item['bytes'] / n / 1e9:9.3f} GB"
                  f"  {item['op']:20s} {item['shape']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
