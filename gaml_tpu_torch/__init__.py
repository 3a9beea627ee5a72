"""gaml_tpu_torch: the PyTorch/CUDA port of gaml_tpu's device seams.

The host layers (graph, index, native C++ aligner, scorers, moves, the
annealer) are gaml_tpu's own and are imported from there.  This package
replaces only the short-read device path: candidate generation, staging,
the banded extension DP (hand-written CUDA kernels K1/K2 for Hopper),
first-wins dedup and the GetTotalProb reduction.  It imports torch and
never jax; every engine takes an explicit ``device``.
"""

__version__ = "0.1.0"
