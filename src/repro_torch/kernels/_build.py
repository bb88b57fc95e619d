"""Build and load the port's CUDA kernels (plain C interface, ``ctypes``).

Each ``csrc/<name>.cu`` compiles on first use into its own shared library
``build/repro_torch/<name>.so`` at the root of the checkout::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -Xptxas -v -o build/repro_torch/<name>.so <name>.cu

(``pairwise.cu`` adds ``--ftz=true``: it flushes subnormals, as XLA:CPU).

The compiler's output (the ``-Xptxas -v`` summary: registers, shared
memory and spills per kernel) is kept beside the library as
``build/repro_torch/<name>.log`` (:func:`build_log`).

The sources include no PyTorch header, so a build takes seconds. Every C
entry point takes raw pointers and a ``cudaStream_t`` and returns
``cudaGetLastError()``; :func:`check` raises on a nonzero code. Nothing
here runs at import, so ``import repro_torch`` works without ``nvcc``.

Every wrapper (the function that launches a kernel on the card and runs
its plain version on the CPU) is marked ``repro_torch.opaque.kernel_call``:
a dispatch mode that listens (the scale-safety interpreter) takes its
result whole, on both devices alike.

Kernels may be first used from several threads at once (the shard threads
of ``core/mesh.py``): one lock serializes the builds and loads, and
:func:`count_launch` adds to the wrappers' launch counters under a lock of
its own, so that no build runs twice and no launch goes uncounted.
"""
from __future__ import annotations

import ctypes
import functools
import os
import shutil
import subprocess
import threading
from pathlib import Path

__all__ = ["SOURCES", "BUILD_DIR", "build_all", "build_log", "library", "check",
           "count_launch"]

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("wavefront", "segment", "pairwise", "nearest")
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"

_NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
               "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# Flags of one source only. pairwise.cu flushes subnormal float inputs and
# results to zero, as XLA:CPU does (ROADMAP C7).
_SOURCE_FLAGS = {"pairwise": ("--ftz=true",)}
_BUILD_LOCK = threading.RLock()
_COUNT_LOCK = threading.Lock()


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                           "machine with the CUDA toolkit")
    return path


def _stale(name: str) -> bool:
    so = BUILD_DIR / f"{name}.so"
    src = CSRC / f"{name}.cu"
    return not so.exists() or so.stat().st_mtime < src.stat().st_mtime


def build_all(names=SOURCES) -> dict[str, str]:
    """Compile every stale source, one ``nvcc`` each, all started together.
    Returns the compiler's output (the ``-Xptxas -v`` summary) per source;
    raises if any build fails."""
    with _BUILD_LOCK:
        return _build_stale(names)


def _build_stale(names) -> dict[str, str]:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for name in names:
        if not _stale(name):
            continue
        tmp = BUILD_DIR / f"{name}.{os.getpid()}.tmp.so"
        cmd = [nvcc, *_NVCC_FLAGS, *_SOURCE_FLAGS.get(name, ()), "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs, failed = {}, []
    for name, (tmp, proc) in procs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(name)
        else:
            (BUILD_DIR / f"{name}.log").write_text(logs[name])
            os.replace(tmp, BUILD_DIR / f"{name}.so")
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n"
                           + "\n".join(logs[f] for f in failed))
    return logs


def build_log(name: str) -> str:
    """The compiler's output of the last build of ``csrc/<name>.cu``."""
    return (BUILD_DIR / f"{name}.log").read_text()


@functools.cache
def _load(name: str) -> ctypes.CDLL:
    build_all((name,))
    return ctypes.CDLL(str(BUILD_DIR / f"{name}.so"))


def library(name: str) -> ctypes.CDLL:
    """The loaded shared library of ``csrc/<name>.cu``, built if stale;
    built and loaded once however many threads ask at once."""
    with _BUILD_LOCK:
        return _load(name)


def count_launch(wrapper, launched: int = 1, instance: str | None = None) -> None:
    """Add ``launched`` to ``wrapper.launches`` (and to
    ``wrapper.instances[instance]``), safe across threads."""
    with _COUNT_LOCK:
        wrapper.launches += launched
        if instance is not None:
            wrapper.instances[instance] += launched


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a C entry point of ``lib`` reported a CUDA error."""
    if code != 0:
        msg = lib.cuda_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")
