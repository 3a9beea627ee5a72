"""Multi-readset likelihood combiner.

Reference ProbCalculator (prob_calculator.h:37-124): the assembly score is
the weighted sum over read sets — single sets via the full single scorer,
paired sets via the incremental scorer (one persistent ScoringState each),
PacBio sets via the banded-forward scorer.  ``zeros`` collects
(floored_read_count, n_reads) per set.

The ``enable_*`` methods move a kind of read set onto the device scorers
of ``parallel/`` (the JAX package's mesh scorers): the paired full or
incremental rescore, the paired running totals, the PacBio forward DP and
reduction.  Under a process group (parallel/distributed.py) each process
scores its own range of reads with them and every process gets the
merged score; in a world of one they score every read.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

from ..utils.metrics import span
from .config import PairedReadConfig, SingleReadConfig
from .pacbio_score import calc_score_for_pacbio
from .paired import ScoringState, calc_score_for_paths_incremental
from .single import calc_score_for_paths_single


class ProbCalculator:
    def __init__(self, single_reads, paired_reads, pacbio_reads, graph):
        """single_reads: [(SingleReadConfig, ReadSet)];
        paired_reads: [(PairedReadConfig, (ReadSet, ReadSet))];
        pacbio_reads: [(SingleReadConfig, PacbioReadSet)]."""
        self.single_reads = list(single_reads)
        self.paired_reads = list(paired_reads)
        self.pacbio_reads = list(pacbio_reads)
        self.graph = graph
        self.paired_scoring_states = [ScoringState() for _ in self.paired_reads]
        self._sharded_paired = None
        self._sharded_scorers = []
        self._sharded_pacbio = None

    def calc_prob(self, paths: Sequence[Sequence[int]],
                  zeros: Optional[List[Tuple[int, int]]] = None):
        """Returns (score, total_len); fills ``zeros`` if given
        (prob_calculator.h:63-109).  Traced as the span ``score``, and
        inside it ``score.pacbio`` around each long-read set's scoring."""
        with span("score"):
            return self._calc_prob(paths, zeros)

    def _calc_prob(self, paths, zeros):
        if zeros is not None:
            zeros.clear()
        prob = 0.0
        total_len = 0
        # one tuple-ization (and one content hash cost per lookup site)
        # per iteration, shared across every read set's scorer
        keys = [p if type(p) is tuple else tuple(p) for p in paths]
        self.prefetch_alignments(paths, keys)
        for cfg, rs in self.single_reads:
            score, zero, total_len = calc_score_for_paths_single(
                self.graph, paths, rs,
                no_cov_penalty=cfg.penalty_constant, exp_cov_move=cfg.step,
                min_prob_per_base=cfg.min_prob_per_base,
                min_prob_start=cfg.min_prob_start)
            prob += score * cfg.weight
            if zeros is not None:
                zeros.append((zero, rs.get_number_of_reads()))
        for ind, (cfg, (rs1, rs2)) in enumerate(self.paired_reads):
            if self._sharded_paired is not None:
                score, zero, total_len = self._calc_paired_sharded(
                    ind, cfg, rs1, rs2, paths, keys)
            else:
                score, zero, total_len = calc_score_for_paths_incremental(
                    self.graph, paths, rs1, rs2, cfg.insert_mean,
                    cfg.insert_std, self.paired_scoring_states[ind],
                    no_cov_penalty=cfg.penalty_constant,
                    exp_cov_move=cfg.step, use_all_to_cov=True,
                    min_prob_per_base=cfg.min_prob_per_base,
                    min_prob_start=cfg.min_prob_start, keys=keys)
            prob += score * cfg.weight
            if zeros is not None:
                zeros.append((zero, rs1.get_number_of_reads()))
        for cfg, rs in self.pacbio_reads:
            kw = dict(no_cov_penalty=cfg.penalty_constant,
                      exp_cov_move=cfg.step,
                      min_prob_per_base=cfg.min_prob_per_base,
                      min_prob_start=cfg.min_prob_start)
            with span("score.pacbio"):
                if self._sharded_pacbio is not None:
                    from ..parallel.pacbio_sharded import (
                        calc_score_for_pacbio_sharded)

                    score, zero, total_len = calc_score_for_pacbio_sharded(
                        self.graph, paths, rs, scorer=self._sharded_pacbio,
                        **kw)
                else:
                    score, zero, total_len = calc_score_for_pacbio(
                        self.graph, paths, rs, **kw)
            prob += score * cfg.weight
            if zeros is not None:
                zeros.append((zero, rs.get_number_of_reads()))
        return prob, total_len

    def score(self, paths: Sequence[Sequence[int]]) -> float:
        return self.calc_prob(paths)[0]

    def prefetch_alignments(self, paths, keys=None) -> None:
        """Pipeline the short-read device-backend miss batches across ALL
        read sets: collect every set's missing windows, dispatch each
        set's kernel batch (async), then block on all results at the end.
        A bulk rescore's four read sets pay ONE collective wait instead of
        four serial launch+fetch round trips.  No-op for non-device read
        sets; cache evolution is
        identical to the sequential precompute (same window unions, same
        insert wave).  Traced as the span ``score.align``."""
        with span("score.align"):
            self._prefetch_alignments(paths, keys)

    def _prefetch_alignments(self, paths, keys) -> None:
        all_rs = [rs for _c, rs in self.single_reads]
        for _c, (r1, r2) in self.paired_reads:
            all_rs.append(r1)
            if r2 is not r1:
                all_rs.append(r2)
        dev_rs = [rs for rs in all_rs if rs.backend == "device"]
        # construct every read set's resident extension engine up front,
        # the largest first
        for rs in sorted(dev_rs, key=lambda r: -r.get_number_of_reads()):
            rs.aligner.ensure_device_extender()
        finishers = []
        for rs in all_rs:
            if rs.backend != "device":
                continue
            collect = set()
            rs.precompute_alignment_for_paths(paths, self.graph, keys=keys,
                                              collect_into=collect)
            if collect:
                fin = rs.precompute_alignment_for_subpaths(
                    self.graph, sorted(collect), defer=True)
                if fin is not None:
                    finishers.append(fin)
        for fin in finishers:
            fin()

    def prefetch_candidates(self, candidates) -> None:
        """Union-prefill every candidate walk-set's missing alignment
        windows in ONE batched aligner call per read set (native OpenMP
        or one device dispatch — amortizing the chip round trip on the
        device backend).  Window alignments are pure functions of the
        window content, so prefilling extra cache entries changes no
        later score — callers that early-exit (the repeat hill-climb)
        keep bit-identical trajectories while paying one dispatch per
        round instead of per candidate.  PacBio sets prefill the same
        way through ONE precompute_ranges_for_paths forward-DP batch;
        the cached logprobs are bit-identical to sequential fills WHEN
        both route to the same kernel — a union batch has more DP cells
        than each per-candidate fill and can cross the device-routing
        threshold where sequential fills would stay on the f64 native
        kernel, in which case values agree to the device route's ~1e-5
        band (the same caveat PARITY.md pins for the device route
        itself)."""
        for _cfg, rs in self.single_reads:
            collect = set()
            for cand in candidates:
                rs.precompute_alignment_for_paths(cand, self.graph,
                                                  collect_into=collect)
            if collect:
                rs.precompute_alignment_for_subpaths(self.graph,
                                                     sorted(collect))
        for _cfg, (rs1, rs2) in self.paired_reads:
            for rs in (rs1, rs2):
                collect = set()
                for cand in candidates:
                    rs.precompute_alignment_for_paths(cand, self.graph,
                                                      collect_into=collect)
                if collect:
                    rs.precompute_alignment_for_subpaths(self.graph,
                                                         sorted(collect))
        for _cfg, rs in self.pacbio_reads:
            all_walks = [w for cand in candidates for w in cand]
            rs.precompute_ranges_for_paths(self.graph, all_walks)

    def score_batch(self, candidates) -> List[float]:
        """Score several candidate walk-sets that will ALL be evaluated
        (the scorer-in-the-loop sites: LocalChange2's 2-way choice,
        FixGapLength's probe pairs — reference moves.cc:104-122, 694-800).
        Union-prefills the alignment caches (see prefetch_candidates),
        then scores sequentially; because every candidate is scored, the
        union equals exactly the window set the sequential plain-score
        path would have inserted, so cache evolution — and every score
        and trajectory — is bit-identical (same-kernel-routing caveat in
        prefetch_candidates applies to PacBio)."""
        self.prefetch_candidates(candidates)
        return [self.score(cand) for cand in candidates]

    def enable_sharded_pacbio(self, device="cuda",
                              forward_on_mesh: bool = True) -> None:
        """Score PacBio sets on ``device`` (parallel.pacbio_sharded): the
        per-read log-sum-exp and floored reduction in float64, and, unless
        forward_on_mesh=False, every forward-DP batch on the read set's
        K5 engine whatever its size (each read set's ``forward_dispatch``;
        the cells count under "mesh").  Under a process group each read
        set runs the forward jobs of this process's reads only (its
        ``read_range``)."""
        from ..parallel import distributed
        from ..parallel.pacbio_sharded import ShardedPacbioScorer

        self._sharded_pacbio = ShardedPacbioScorer(device)
        for _cfg, rs in self.pacbio_reads:
            if forward_on_mesh:
                rs.forward_dispatch = True
            if distributed.world()[1] > 1:
                # this process's reads' forward jobs only
                rs.read_range = distributed.read_range(
                    rs.get_number_of_reads())

    def enable_sharded_paired(self, device="cuda",
                              incremental: bool = False) -> None:
        """Score paired sets on ``device`` (parallel.paired_sharded): pair
        products, event flags and the floored reduction in float64.

        incremental=False: full-rescore semantics on every call (every
        walk restaged).  incremental=True: per move the walk multiset is
        diffed on the host and only the changed walks' pair products run
        on the device, added as signed per-read totals into
        device-resident running totals (reference CalcScoreForPathsNew,
        graph.cc:1952-1989).  Under a process group each process stages
        and totals its own reads' pair rows."""
        self._sharded_paired = (device, incremental)
        self._sharded_scorers = [None] * len(self.paired_reads)

    def _calc_paired_sharded(self, ind, cfg, rs1, rs2, paths, keys=None):
        """One paired set's score through its device scorer, made at the
        first call and reused after."""
        from ..parallel.paired_sharded import (
            calc_score_for_paths_incremental_sharded,
            calc_score_for_paths_paired_sharded, paired_scorer)

        device, incremental = self._sharded_paired
        scorer = self._sharded_scorers[ind]
        if scorer is None:
            scorer = paired_scorer(rs1, rs2, cfg.insert_mean, cfg.insert_std,
                                   cfg.penalty_constant != 0.0, device)
            self._sharded_scorers[ind] = scorer
        kw = dict(no_cov_penalty=cfg.penalty_constant, exp_cov_move=cfg.step,
                  use_all_to_cov=True,
                  min_prob_per_base=cfg.min_prob_per_base,
                  min_prob_start=cfg.min_prob_start, scorer=scorer)
        if incremental:
            return calc_score_for_paths_incremental_sharded(
                self.graph, paths, rs1, rs2, cfg.insert_mean,
                cfg.insert_std, self.paired_scoring_states[ind], keys=keys,
                **kw)
        return calc_score_for_paths_paired_sharded(
            self.graph, paths, rs1, rs2, cfg.insert_mean, cfg.insert_std,
            **kw)

    def enable_device_scoring_state(self, device="cuda") -> None:
        """Keep the paired running per-read totals on ``device``
        (parallel.device_state; under a process group this process's
        reads' totals); the host arrays stop being maintained
        (checkpointing gathers from the device)."""
        from ..parallel.device_state import DeviceScoringState

        for (_cfg, (rs1, rs2)), st in zip(self.paired_reads,
                                          self.paired_scoring_states):
            lens = rs1.read_lens_array() + rs2.read_lens_array()
            dev = DeviceScoringState(rs1.get_number_of_reads(), lens,
                                     device=device)
            if len(st.probs):
                dev.from_host(st.probs)
            st.device = dev
