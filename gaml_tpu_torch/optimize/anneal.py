"""Simulated-annealing driver (reference Optimize, gaml.cc:91-343).

Move selection by integer-weight roulette, cooling T = t0/log(it+1),
greedy acceptance of improvements with Metropolis acceptance only for break
moves, per-iteration long-node bookkeeping (re-add missing long nodes, drop
lone walks duplicating nodes used elsewhere), best-tracking, periodic
output, and reach-cache write-back of accepted local reroutes.

Beyond the reference: structured per-phase metrics (utils.metrics: the
timers ``propose`` and ``rescore``, the counters ``moves.*``; while tracing
is on the spans ``move`` and ``propose`` and the counter
``moves.advice_pacbio``, one a long-read advice move proposed) and real
checkpoint/resume
of (walks, best, RNG state, iteration, scoring states).
"""
from __future__ import annotations

import math
import time
from typing import List, Optional

import numpy as np

from ..core.io import output_paths_to_file
from ..core.paths import Path
from ..moves.advice import extend_paths_adv_pacbio, extend_paths_adv_paired
from ..moves.extend import extend_paths
from ..moves.gaps import fix_random_gap_length
from ..moves.repeats import fix_big_reps, fix_some_big_reps
from ..moves.structural import break_path, local_change
from ..utils.metrics import Metrics, count, span
from ..utils.rng import GamlRng
from .settings import AssemblySettings

KMER = 47  # reference hardcodes kmer=47 inside Optimize (gaml.cc:102)


def _clean_lone_duplicates(paths: List[Path], local_p: Optional[int] = None):
    """Drop single-node walks whose node (or complement) also appears in
    another walk (reference gaml.cc:120-144 / gaml.cc:244-271).  Returns
    the possibly-adjusted local_p.

    The reference removes one walk per full rescan (the LAST matching lone
    walk), because a removal can turn another lone walk from duplicated to
    unique.  A removal only decrements its own canonical-node count, so the
    rescan loop is simulated on a counts table over one flatten: repeatedly
    take the last lone walk whose canonical count is still > 1."""
    singles = [i for i, p in enumerate(paths) if len(p) == 1]
    if not singles:
        return local_p
    # entry e lands in locs[e] and locs[e^1]; a lone walk [x] is dropped
    # iff some OTHER entry e' has e' in {x, x^1}.  A lone walk contributes
    # exactly one such entry itself: count canonical pairs, test > 1.
    flat: List[int] = []
    for p in paths:
        flat.extend(p)
    a = np.asarray(flat, dtype=np.int64)
    keys = np.where(a >= 0, a & ~np.int64(1), np.minimum(a, a ^ 1))
    uniq, cnts = np.unique(keys, return_counts=True)
    counts = dict(zip(uniq.tolist(), cnts.tolist()))
    sk = np.asarray([paths[i][0] for i in singles], dtype=np.int64)
    skeys = np.where(sk >= 0, sk & ~np.int64(1),
                     np.minimum(sk, sk ^ 1)).tolist()
    removed: List[int] = []
    alive = list(range(len(singles)))
    while True:
        clean_slot = -1
        for j in reversed(alive):
            if counts[skeys[j]] > 1:
                clean_slot = j
                break
        if clean_slot == -1:
            break
        counts[skeys[clean_slot]] -= 1
        alive.remove(clean_slot)
        removed.append(singles[clean_slot])
    for idx in sorted(removed, reverse=True):
        if local_p is not None and idx < local_p:
            local_p -= 1
        del paths[idx]
    return local_p


class Optimizer:
    def __init__(self, graph, prob_calc, settings: AssemblySettings,
                 advice_paired=None, advice_pacbio=None,
                 longest_read: int = 100, rng: Optional[GamlRng] = None,
                 log=print, metrics=None):
        self.graph = graph
        self.prob_calc = prob_calc
        self.settings = settings
        self.advice_paired = advice_paired or []
        self.advice_pacbio = advice_pacbio or []
        self.longest_read = longest_read
        self.rng = rng or GamlRng(settings.seed)
        self.log = log
        self.metrics = metrics or Metrics()
        self.itnum = 0
        self.cur_prob = None
        self.best_prob = None
        self.best_paths: List[Path] = []
        self.history: List[dict] = []

    # ------------------------------------------------------------------ runs
    def prepare(self):
        gr = self.graph
        if not gr.reach_self:
            gr.calc_reachability()
        if not gr.reach_big:
            gr.calc_reachability_big(self.settings.threshold)
        if not gr.reach_limit:
            gr.calc_reachability_limit(2 * self.longest_read)

    def run(self, paths: List[Path], write_outputs: bool = True) -> List[Path]:
        s = self.settings
        gr = self.graph
        self.prepare()
        paths = [list(p) for p in paths]

        self.cur_prob, total_len = self.prob_calc.calc_prob(paths)
        self.log(f"start prob {self.cur_prob:.6f} len {total_len}")
        if write_outputs:
            output_paths_to_file(paths, gr, KMER, s.threshold, s.output_prefix)

        _clean_lone_duplicates(paths)
        self.best_prob = self.cur_prob
        self.best_paths = [list(p) for p in paths]

        while self.itnum <= s.max_iterations:
            paths = self.step(paths, write_outputs=write_outputs)
            if s.checkpoint_every and self.itnum % s.checkpoint_every == 0 \
                    and s.checkpoint_prefix:
                from .checkpoint import save_checkpoint
                save_checkpoint(self, paths, s.checkpoint_prefix,
                                write=write_outputs)
        if write_outputs:
            output_paths_to_file(self.best_paths, gr, KMER, s.threshold,
                                 s.output_prefix)
        return self.best_paths

    # ------------------------------------------------------------------ step
    def step(self, paths: List[Path], write_outputs: bool = True) -> List[Path]:
        """One annealing iteration; returns the (possibly updated) current
        walk set.  Failed move proposals do not count as iterations
        (reference `continue`, gaml.cc:173-212)."""
        with span("move"):
            return self._step(paths, write_outputs)

    def _step(self, paths: List[Path], write_outputs: bool) -> List[Path]:
        s = self.settings
        gr = self.graph
        rng = self.rng
        t_propose = time.perf_counter()
        attempts = 0
        with span("propose"):
            while True:
                attempts += 1
                if attempts > 200_000:
                    # no move family can succeed on this walk set (e.g. an
                    # edge-less bootstrap graph with unbreakable walks) —
                    # the reference would spin in its retry loop forever
                    # (gaml.cc:173-212 `continue`); stop the run cleanly
                    self.log("no applicable move after 200000 proposals - "
                             "stopping early")
                    self.itnum = s.max_iterations + 1
                    return paths
                new_paths = [list(p) for p in paths]
                extendadvp = s.extendadvp
                if not self.advice_paired and not self.advice_pacbio:
                    extendadvp = 0
                total_w = (s.extendp + s.breakp + s.fixp + s.localp +
                           extendadvp + s.fixlenp)
                r = rng.randint(total_w)
                was_local = False
                was_break = False
                local_p = local_s = local_t = -1

                if s.do_postprocess:
                    fix_big_reps(new_paths, gr, s.threshold, True,
                                 self.prob_calc)
                elif r < s.extendp:
                    if not extend_paths(new_paths, gr, s.threshold,
                                        self.prob_calc, rng):
                        continue
                elif r < s.extendp + s.fixp:
                    if not fix_some_big_reps(new_paths, gr, s.threshold,
                                             False, self.prob_calc, rng):
                        continue
                elif r < s.extendp + s.fixp + s.localp:
                    ok, local_p, local_s, local_t = local_change(
                        new_paths, gr, s.threshold, self.prob_calc, rng)
                    if not ok:
                        continue
                    if local_p != -1:
                        was_local = True
                elif r < s.extendp + s.fixp + s.localp + extendadvp:
                    r2 = rng.randint(len(self.advice_pacbio) +
                                     len(self.advice_paired))
                    if r2 < len(self.advice_pacbio):
                        advice_set = self.advice_pacbio[
                            rng.randint(len(self.advice_pacbio))]
                        if not extend_paths_adv_pacbio(
                                new_paths, gr, s.threshold, advice_set, KMER,
                                self.prob_calc, rng):
                            continue
                        count("moves.advice_pacbio")
                    else:
                        rs1, rs2 = self.advice_paired[
                            rng.randint(len(self.advice_paired))]
                        if not extend_paths_adv_paired(
                                new_paths, gr, s.threshold, rs1, rs2, KMER,
                                self.prob_calc, rng):
                            continue
                elif r < (s.extendp + s.fixp + s.localp + extendadvp +
                          s.fixlenp):
                    if not fix_random_gap_length(new_paths, self.prob_calc,
                                                 rng):
                        continue
                else:
                    if not break_path(new_paths, gr, s.threshold, rng):
                        continue
                    was_break = True
                break

        agg = self.metrics.timers["propose"]
        agg[0] += time.perf_counter() - t_propose
        agg[1] += 1
        # re-add missing long nodes (presence over the *old* walks,
        # additions into the new, ascending id — reference gaml.cc:216-241).
        # The missing set depends only on the accepted walk set, which is
        # unchanged across rejected iterations — cached by object identity.
        readd = getattr(self, "_readd_cache", None)
        if readd is None or readd[0] is not paths:
            lens = gr.lens_np()
            key = (gr.num_nodes, s.threshold)
            if getattr(self, "_long_ids_key", None) != key:
                ids = np.arange(0, gr.num_nodes, 2)
                self._long_ids = ids[lens[ids] > s.threshold]
                self._long_ids_key = key
            flat = np.asarray([e for p in paths for e in p], dtype=np.int64)
            nn = flat[flat >= 0] if len(flat) else flat
            sel = nn[lens[nn] > s.threshold] if len(nn) else nn
            mark = np.zeros(gr.num_nodes, dtype=bool)
            mark[(sel // 2) * 2] = True
            readd = (paths, self._long_ids[~mark[self._long_ids]])
            self._readd_cache = readd
        for node in readd[1]:
            new_paths.append([int(node)])

        local_p = _clean_lone_duplicates(new_paths,
                                         local_p if was_local else None)
        if local_p is None:
            local_p = -1

        self.itnum += 1
        T = s.t0 / math.log(self.itnum + 1)
        if write_outputs and self.itnum % 100 == 0:
            output_paths_to_file(self.best_paths, gr, KMER, s.threshold,
                                 s.output_prefix)

        zeros = []
        with self.metrics.timer("rescore"):
            new_prob, total_len = self.prob_calc.calc_prob(new_paths, zeros)

        accept = False
        if new_prob > self.cur_prob or s.do_postprocess:
            if was_local:
                pp = [new_paths[local_p][i] for i in range(local_s + 1, local_t)]
                sa = new_paths[local_p][local_s]
                ta = new_paths[local_p][local_t]
                if ta in gr.reach_big[sa]:
                    gr.reach_big[sa][ta] = pp
                if ta in gr.reach_limit[sa]:
                    gr.reach_limit[sa][ta] = pp
            accept = True
        elif was_break:
            prob = math.exp((new_prob - self.cur_prob) / T)
            if rng.uniform() < prob:
                accept = True
        if accept:
            self.cur_prob = new_prob
            paths = new_paths
        if new_prob > self.best_prob:
            self.best_prob = new_prob
            self.best_paths = [list(p) for p in new_paths]

        stamp = time.strftime("%H:%M:%S")
        zeros_str = " ".join(f"{a}/{b}" for a, b in zeros)
        self.log(f"itnum {self.itnum} temp {T:.6f} time {stamp} "
                 f"new prob {new_prob:.6f} {self.cur_prob:.6f} "
                 f"{self.best_prob:.6f} len {total_len} paths "
                 f"{len(new_paths)} low prob reads {zeros_str}")
        self.metrics.count("moves.accepted" if accept else "moves.rejected")
        record = dict(itnum=self.itnum, T=T, new_prob=new_prob,
                      cur_prob=self.cur_prob, best_prob=self.best_prob,
                      total_len=total_len, n_paths=len(new_paths),
                      accept=accept)
        self.history.append(record)
        return paths
