"""GAML config-file compatibility layer.

Parses the reference's INI-ish format (reference LoadConfig,
gaml.cc:737-780): ``key=value`` lines, ``[section]`` opens a read-set scope,
global keys before the first section; only lines starting with a lowercase
letter are key/value lines (comments or anything else are skipped).

Read-set factory semantics (reference PrepareReadSetFromConfig,
gaml.cc:783-872), with the reference's load-bearing quirks preserved:
- ``match_prob = 1 - 4 * mismatch_prob``;
- paired sets read min_prob_per_base from the misspelled key
  ``min_prob_pre_base`` (gaml.cc:855) — the documented spelling silently
  falls back to -0.7;
- paired ``step = insert_mean - penalty_step`` (default penalty_step 50).

We additionally accept ``min_prob_per_base`` for paired sets when the
misspelled key is absent IF ``strict_compat=False`` (our default is strict).
"""
from __future__ import annotations

from typing import Dict

from .scoring.config import PairedReadConfig, SingleReadConfig


def parse_config_text(text: str):
    configs: Dict[str, str] = {}
    read_set_configs: Dict[str, Dict[str, str]] = {}
    current = ""
    for line in text.splitlines():
        if not line:
            continue
        if line[0] == "[":
            current = line[1:-1] if line.endswith("]") else line[1:]
        elif "a" <= line[0] <= "z":
            if "=" not in line:
                raise ValueError(f"Bad line in config file:\n{line}")
            key, value = line.split("=", 1)
            if current:
                read_set_configs.setdefault(current, {})[key] = value
            else:
                configs[key] = value
    return configs, read_set_configs


def load_config(path: str):
    with open(path) as f:
        return parse_config_text(f.read())


def _getf(cfg: Dict[str, str], key: str, default: float) -> float:
    return float(cfg[key]) if key in cfg else default


def prepare_read_sets(read_set_configs: Dict[str, Dict[str, str]],
                      backend: str = "bfs", strict_compat: bool = True,
                      device="cuda"):
    """Build (single, paired, pacbio) read-set lists from parsed sections.
    ``device`` is where the read sets' device work runs (the short-read
    device backend, the PacBio forward DP above its size threshold).

    Returns ([(SingleReadConfig, ReadSet)],
             [(PairedReadConfig, (ReadSet, ReadSet))],
             [(SingleReadConfig, PacbioReadSet)])."""
    from .scoring.readset import ReadSet

    single, paired, pacbio = [], [], []
    for name, cfg in read_set_configs.items():
        cache_prefix = cfg.get("cache_prefix", name)
        if "type" not in cfg:
            continue
        weight = _getf(cfg, "weight", 1.0)
        advice = "advice" in cfg

        if cfg["type"] in ("single", "pacbio"):
            if "filename" not in cfg:
                continue
            mismatch = _getf(cfg, "mismatch_prob", 0.01)
            match = 1.0 - 4 * mismatch
            scfg = SingleReadConfig(
                penalty_constant=_getf(cfg, "penalty_constant", 0.0),
                step=_getf(cfg, "penalty_step", 50.0),
                min_prob_per_base=_getf(cfg, "min_prob_per_base", -0.7),
                min_prob_start=_getf(cfg, "min_prob_start", -10.0),
                weight=weight, advice=advice)
            if cfg["type"] == "single":
                rs = ReadSet(cache_prefix, cfg["filename"], match, mismatch,
                             backend=backend, device=device)
                single.append((scfg, rs))
            else:
                from .scoring.pacbio import PacbioReadSet

                rs = PacbioReadSet(cache_prefix, cfg["filename"], match,
                                   mismatch, device=device)
                pacbio.append((scfg, rs))
        elif cfg["type"] == "paired":
            if not all(k in cfg for k in
                       ("filename1", "filename2", "insert_mean", "insert_std")):
                continue
            insert_mean = float(cfg["insert_mean"])
            insert_std = float(cfg["insert_std"])
            mismatch = _getf(cfg, "mismatch_prob", 0.01)
            match = 1.0 - 4 * mismatch
            mppb_key = "min_prob_pre_base"  # sic (gaml.cc:855)
            if not strict_compat and mppb_key not in cfg:
                mppb_key = "min_prob_per_base"
            pcfg = PairedReadConfig(
                penalty_constant=_getf(cfg, "penalty_constant", 0.0),
                step=insert_mean - _getf(cfg, "penalty_step", 50.0),
                insert_mean=insert_mean, insert_std=insert_std,
                min_prob_per_base=_getf(cfg, mppb_key, -0.7),
                min_prob_start=_getf(cfg, "min_prob_start", -10.0),
                weight=weight, advice=advice)
            rs1 = ReadSet(cache_prefix + "1", cfg["filename1"], match,
                          mismatch, backend=backend, device=device)
            rs2 = ReadSet(cache_prefix + "2", cfg["filename2"], match,
                          mismatch, backend=backend, device=device)
            paired.append((pcfg, (rs1, rs2)))
    return single, paired, pacbio
