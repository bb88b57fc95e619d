"""Serving example on the port: batched prefill + lock-step decode on a
smoke model; the twin of ``examples/serve_batched.py``.

  PYTHONPATH=src python examples/serve_batched_torch.py [--arch gemma2-9b] [--device cpu]

Without ``--device`` it runs on the CUDA card.
"""
import argparse
import sys

from repro_torch.launch.serve import main as serve_main

if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma2-9b")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args()
    argv = ["--arch", args.arch, "--smoke", "--requests", "4", "--prompt-len", "32",
            "--gen-tokens", "12"]
    if args.device is not None:
        argv += ["--device", args.device]
    serve_main(argv)
    sys.exit(0)
