"""Random number generation for the host-side optimizer.

The reference mixes C ``rand()`` (implicitly seeded 1) with a fixed-seed
``default_random_engine(47)`` (graph.cc:38-40); exact move-trajectory
reproduction is platform-specific even for the reference itself, so we use a
single seeded numpy Generator for everything.  Parity is defined on
likelihood-of-a-given-assembly (deterministic) rather than on move traces
(SURVEY.md section 7, "RNG semantics").
"""
from __future__ import annotations

import numpy as np


class GamlRng:
    """Thin wrapper bundling the integer/real sampling idioms the move
    engine needs, with a checkpointable state."""

    def __init__(self, seed: int = 47):
        self._gen = np.random.Generator(np.random.PCG64(seed))

    def randint(self, n: int) -> int:
        """Uniform int in [0, n) (reference ``rand() % n`` idiom)."""
        return int(self._gen.integers(0, n))

    def uniform(self, lo: float = 0.0, hi: float = 1.0) -> float:
        return float(self._gen.uniform(lo, hi))

    def choice(self, seq):
        return seq[self.randint(len(seq))]

    def state(self):
        return self._gen.bit_generator.state

    def set_state(self, state) -> None:
        self._gen.bit_generator.state = state
