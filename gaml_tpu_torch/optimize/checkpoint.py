"""Optimizer checkpoint/resume.

The reference has no optimizer-state checkpoint — resume means restarting
from the periodically written output FASTA (SURVEY.md section 5.4).  Here we
persist the full state: current and best walk sets, scores, iteration, RNG
state, and the paired ScoringStates, so a run continues bit-exactly.
"""
from __future__ import annotations

import pickle
from typing import List

from ..core.paths import Path


def save_checkpoint(optimizer, paths: List[Path], prefix: str,
                    write: bool = True) -> str:
    state = {
        "itnum": optimizer.itnum,
        "cur_prob": optimizer.cur_prob,
        "best_prob": optimizer.best_prob,
        "paths": [list(p) for p in paths],
        "best_paths": [list(p) for p in optimizer.best_paths],
        "rng_state": optimizer.rng.state(),
        "scoring_states": [
            {"old_paths": st.old_paths, "bad_bases": st.bad_bases,
             "probs": (st.device.to_host()
                       if getattr(st, "device", None) is not None
                       else st.probs)}
            for st in optimizer.prob_calc.paired_scoring_states
        ],
    }
    path = f"{prefix}.ckpt"
    # under a process group every process gathers the device totals above
    # and only the one that writes outputs writes the file
    if write:
        with open(path, "wb") as f:
            pickle.dump(state, f)
    return path


def load_checkpoint(optimizer, prefix: str) -> List[Path]:
    with open(f"{prefix}.ckpt", "rb") as f:
        state = pickle.load(f)
    optimizer.itnum = state["itnum"]
    optimizer.cur_prob = state["cur_prob"]
    optimizer.best_prob = state["best_prob"]
    optimizer.best_paths = [list(p) for p in state["best_paths"]]
    optimizer.rng.set_state(state["rng_state"])
    for st, saved in zip(optimizer.prob_calc.paired_scoring_states,
                         state["scoring_states"]):
        st.old_paths = saved["old_paths"]
        st.bad_bases = saved["bad_bases"]
        st.probs = saved["probs"]
        if getattr(st, "device", None) is not None:
            st.device.from_host(st.probs)
    return [list(p) for p in state["paths"]]
