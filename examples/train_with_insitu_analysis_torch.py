"""End-to-end training run on the PyTorch/CUDA port, the twin of
``examples/train_with_insitu_analysis.py``: train xlstm-350m for a few
hundred steps with the paper's technique running in situ (the HACC
pattern: solver steps, then DBSCAN at a cadence, here over the token
embeddings on the traversal and segment kernels), with async checkpoints
and the straggler watchdog, through ``repro_torch.launch.train``.

  PYTHONPATH=src python examples/train_with_insitu_analysis_torch.py \\
      [--steps 300] [--full-100m] [--device cpu]

The default is the smoke config; ``--full-100m`` trains the real
xlstm-350m config (full width and depth on the port). The default device
is the CUDA card. Checkpoints go to a fresh temporary directory.
"""
import argparse
import shutil
import tempfile

from repro_torch.launch.train import main as train_main


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--full-100m", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    ckpt = tempfile.mkdtemp(prefix="repro_torch_e2e_ckpt_")
    try:
        argv = ["--arch", "xlstm-350m", "--steps", str(args.steps),
                "--batch", "8", "--seq", "128", "--ckpt-dir", ckpt,
                "--insitu-every", "25", "--ckpt-every", "100"]
        if not args.full_100m:
            argv.append("--smoke")
        if args.device is not None:
            argv += ["--device", args.device]
        return train_main(argv)
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)


if __name__ == "__main__":
    main()
