"""PyTorch/CUDA port of ``repro`` for one NVIDIA H100.

The layout mirrors ``src/repro/`` file for file: ``repro_torch/core/bvh.py``
ports ``repro/core/bvh.py`` and so on. The JAX package is the reference and
is never imported here. Plain tensor code is PyTorch; each Pallas TPU kernel
of the ported slice is a CUDA C++ kernel for ``sm_90a`` under
``kernels/csrc/``, compiled on first use (see ``kernels/_build.py``).

Entry points (``fdbscan``, ``dbscan_graph_cc``, ``fdbscan_grid``,
``fdbscan_grid_auto``, ``halo_catalog``, ``simulation_halo_stats``,
``InsituAnalyzer``) run on the card unless the caller passes
``device="cpu"``; without a card and without that request they raise.
"""

# The core package first: its re-exports reach ``kernels.wavefront``, which
# reads ``core.bvh``, so an import that starts at a kernel module would
# otherwise find the core half-initialized.
from repro_torch import core  # noqa: E402,F401
