from .config import SingleReadConfig, PairedReadConfig
from .readset import ReadSet
from .calculator import ProbCalculator, ScoringState
