"""gaml_tpu_torch: the PyTorch/CUDA port of gaml_tpu.

The port stands on its own: its host layers (graph, index, the native C++
aligner in ``csrc/gaml_native.cc``, scorers, moves, the annealer, config
and CLI) are its own copies of the JAX package's, and its device paths
are torch: the short-read rescore (candidate generation, the exact
two-direction extension kernel, first-wins dedup, the GetTotalProb
reduction), the device likelihood models and the aligner's batch path for
reads of mixed lengths, and the PacBio banded forward DP.  Every Pallas
kernel of gaml_tpu has a hand-written CUDA counterpart in ``csrc/``.  It
imports torch, never jax, and nothing of gaml_tpu; its entry points run
on the card (``device="cuda"``) unless the caller asks for the CPU.
"""

__version__ = "0.1.0"
