"""Optimizer settings (reference AssemblySettings, gaml.cc:53-88).

Config-key compatibility notes (reference quirks preserved, SURVEY.md 5.6):
- the long-contig threshold key is ``long_contig_threshold`` (the reference
  README documents ``threshold`` but the code reads the long form);
- postprocess mode is triggered by the (sic) key ``do_proprocess``;
- ``fixlen_p`` exists in code but not in the reference README.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict


@dataclass
class AssemblySettings:
    threshold: int = 500
    output_prefix: str = "output"
    max_iterations: int = 50000
    do_postprocess: bool = False
    extendadvp: int = 25
    extendp: int = 5
    breakp: int = 60
    fixp: int = 1
    localp: int = 60
    fixlenp: int = 1
    t0: float = 0.008
    # extensions beyond the reference
    seed: int = 47
    checkpoint_prefix: str = ""
    checkpoint_every: int = 0

    @classmethod
    def from_config(cls, configs: Dict[str, str]) -> "AssemblySettings":
        def geti(key, default):
            return int(configs[key]) if key in configs else default

        def getf(key, default):
            return float(configs[key]) if key in configs else default

        s = cls()
        s.threshold = geti("long_contig_threshold", 500)
        s.output_prefix = configs.get("output_prefix", "output")
        s.max_iterations = geti("max_iterations", 50000)
        if "do_proprocess" in configs:  # sic — load-bearing typo (gaml.cc:71)
            s.do_postprocess = True
            s.max_iterations = 1
        s.extendadvp = geti("join_by_advice_p", 25)
        s.extendp = geti("extend_p", 5)
        s.breakp = geti("disconnect_p", 60)
        s.fixp = geti("interchange_p", 1)
        s.localp = geti("local_p", 60)
        s.fixlenp = geti("fixlen_p", 1)
        s.t0 = getf("t0", 0.008)
        s.seed = geti("seed", 47)
        s.checkpoint_prefix = configs.get("checkpoint_prefix", "")
        s.checkpoint_every = geti("checkpoint_every", 0)
        return s
