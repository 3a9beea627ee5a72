"""gaml_tpu_torch: the PyTorch/CUDA port of gaml_tpu's device seams.

The host layers (graph, index, native C++ aligner, scorers, moves, the
annealer) are gaml_tpu's own and are imported from there.  This package
replaces the device paths: the short-read rescore (candidate generation,
staging, the banded extension DP, first-wins dedup, the GetTotalProb
reduction), the device likelihood models and the aligner's batch path for
reads of mixed lengths, and the PacBio banded forward DP.  Every Pallas
kernel of gaml_tpu has a hand-written CUDA counterpart in ``csrc/``.  It
imports torch and never jax; every engine takes an explicit ``device``.
"""

__version__ = "0.1.0"
