"""Checkpoints: an npz shard and a JSON manifest per step, atomic commit,
an async save thread; port of ``repro/checkpoint/store.py`` with the
reference's layout, so that either package reads the other's:

  <dir>/step_<N>/
    manifest.json          # step, leaf paths, shapes, dtypes, shard count
    shard_0.npz            # leaf arrays, keyed by the leaf's path string
    COMMIT                 # written LAST: a checkpoint without it is torn

A leaf's key is the string ``jax.tree_util.keystr`` gives the same leaf
(``.params['embed']``, ``.opt.step``). numpy has no bfloat16: a bf16
tensor is stored as its bits in a ``uint16`` array and its manifest entry
says ``"bfloat16"`` (the reference's bf16 arrays arrive as 2-byte void
arrays with the same entry, read the same way).
"""
from __future__ import annotations

import json
import os
import pathlib
import shutil
import tempfile
import threading
import time

import numpy as np
import torch

from repro_torch.tree import keystr, leaves_with_path, unflatten_like


def _to_host(t: torch.Tensor) -> np.ndarray:
    t = t.detach()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).cpu().numpy().view(np.uint16)
    return t.cpu().numpy()


def _from_host(a: np.ndarray, dtype_name: str) -> torch.Tensor:
    if dtype_name == "bfloat16":
        bits = np.ascontiguousarray(a).view(np.uint16).astype(np.int16)
        return torch.from_numpy(bits).view(torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True))


class CheckpointStore:
    def __init__(self, directory: str | os.PathLike):
        self.dir = pathlib.Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self._async_thread: threading.Thread | None = None

    # --- save ---------------------------------------------------------------

    def _host_leaves(self, tree) -> dict[str, tuple[np.ndarray, str]]:
        """{path: (host array, manifest dtype)} of every leaf."""
        out = {}
        for path, t in leaves_with_path(tree):
            a = _to_host(t)
            out[keystr(path)] = (a, "bfloat16" if t.dtype == torch.bfloat16
                                 else str(a.dtype))
        return out

    def save(self, step: int, tree) -> pathlib.Path:
        """Synchronous atomic save."""
        return self._write(step, self._host_leaves(tree))

    def save_async(self, step: int, tree) -> None:
        """The device-to-host copy happens now (so training can step on),
        the disk write on a background thread."""
        self.wait()
        host = self._host_leaves(tree)
        self._async_thread = threading.Thread(
            target=self._write, args=(step, host), daemon=True)
        self._async_thread.start()

    def wait(self) -> None:
        if self._async_thread is not None:
            self._async_thread.join()
            self._async_thread = None

    def _write(self, step: int, host: dict) -> pathlib.Path:
        final = self.dir / f"step_{step:08d}"
        tmp = pathlib.Path(tempfile.mkdtemp(dir=self.dir, prefix=".tmp_"))
        try:
            np.savez(tmp / "shard_0.npz", **{k: a for k, (a, _) in host.items()})
            manifest = {
                "step": step,
                "time": time.time(),
                "leaves": {k: {"shape": list(a.shape), "dtype": name}
                           for k, (a, name) in host.items()},
                "num_shards": 1,
            }
            (tmp / "manifest.json").write_text(json.dumps(manifest, indent=2))
            (tmp / "COMMIT").write_text("ok")
            if final.exists():
                shutil.rmtree(final)
            tmp.rename(final)
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise
        return final

    # --- restore --------------------------------------------------------------

    def steps(self) -> list[int]:
        out = []
        for p in self.dir.glob("step_*"):
            if (p / "COMMIT").exists():
                out.append(int(p.name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> int | None:
        s = self.steps()
        return s[-1] if s else None

    def restore(self, template, step: int | None = None):
        """Restore into the structure of ``template``: each leaf takes the
        device and dtype of the template's leaf at its path."""
        if step is None:
            step = self.latest_step()
            if step is None:
                raise FileNotFoundError(f"no committed checkpoints in {self.dir}")
        path = self.dir / f"step_{step:08d}"
        if not (path / "COMMIT").exists():
            raise FileNotFoundError(f"checkpoint {path} is torn (no COMMIT)")
        manifest = json.loads((path / "manifest.json").read_text())["leaves"]
        data = np.load(path / "shard_0.npz")
        out = []
        for p, t in leaves_with_path(template):
            key = keystr(p)
            x = _from_host(data[key], manifest[key]["dtype"])
            out.append(x.to(device=t.device, dtype=t.dtype))
        return unflatten_like(template, out), step

    def prune(self, keep: int = 3) -> None:
        for s in self.steps()[:-keep]:
            shutil.rmtree(self.dir / f"step_{s:08d}", ignore_errors=True)
