"""Read-set scoring configuration (reference prob_calculator.h:7-35)."""
from __future__ import annotations

from dataclasses import dataclass


@dataclass
class SingleReadConfig:
    penalty_constant: float = 0.0
    step: float = 50.0            # exp_cov_move in the coverage sweep
    min_prob_per_base: float = -0.7
    min_prob_start: float = -10.0
    weight: float = 1.0
    advice: bool = False


@dataclass
class PairedReadConfig:
    penalty_constant: float = 0.0
    step: float = 0.0             # insert_mean - penalty_step (gaml.cc:860)
    insert_mean: float = 0.0
    insert_std: float = 0.0
    min_prob_per_base: float = -0.7
    min_prob_start: float = -10.0
    weight: float = 1.0
    advice: bool = False
