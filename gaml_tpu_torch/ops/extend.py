"""Banded short-read extension: constants and the exact torch DP.

Torch twin of gaml_tpu.ops.extend._dp_rows (the reference ProcessHit
0-1 BFS, graph.cc:753-837, collapsed into a 7-diagonal min-plus DP).
``dp_rows`` is the exact oracle of the CUDA kernels K1/K2
(ops.extend_cuda) and of their plain versions.
"""
from __future__ import annotations

import torch

PAD = 4          # gwin padding; diagonal drift is at most 3
BAND = 7         # offsets d in [-3, 3]
INF = 100
INVALID_A = 100  # accept offset of a cell with no preferred accept edge
ERROR_LIMIT = 3
K = 15
SENT_READ = 6    # read padding sentinel
SENT_GEN = 8     # out-of-genome sentinel (never equals any read code)


def dp_rows(read: torch.Tensor, rlen: torch.Tensor, gwin: torch.Tensor,
            glen: torch.Tensor, rmax: int):
    """Cost-to-accept DP with accept-offset propagation.

    read: [N, rmax] direction-view read codes; rlen: [N];
    gwin: [N, rmax + 2*PAD] with gwin[n, j] = genome_view[j - PAD];
    glen: [N].  Rows run from rmax-1 down to 0; rows >= rlen accept at
    cost 0.  Per row the moves are: match on the diagonal (the last
    genome char only if it ends the read), substitution, read-skip to
    d-1, and genome-skip to d+1 (relaxed 3x).  The accept offset follows
    the BFS tie-break: match keeps, then substitution, then genome-skip,
    then read-skip.  Returns (c0, a0), int32 [N, BAND] at row 0; the
    start state is d = 0 (index 3).
    """
    n = read.shape[0]
    dev = read.device
    d_off = torch.arange(-3, 4, dtype=torch.int32, device=dev)
    rlen = rlen.to(torch.int32).unsqueeze(1)
    glen = glen.to(torch.int32).unsqueeze(1)
    inf = torch.full((n, 1), INF, dtype=torch.int32, device=dev)
    invalid = torch.full((n, 1), INVALID_A, dtype=torch.int32, device=dev)
    c = torch.zeros((n, BAND), dtype=torch.int32, device=dev)
    a = d_off.expand(n, BAND).clone()
    for r in range(rmax - 1, -1, -1):
        # chars on diagonals d=-3..3 at row r: j = r + d + PAD
        chars = gwin[:, r + PAD - 3:r + PAD + 4]
        match = chars == read[:, r:r + 1]
        nomatch = ~match
        g_plus_in = (r + d_off + 1) < glen
        last_row = (r + 1) == rlen

        diag = torch.where(match & (g_plus_in | last_row), c, INF)
        sub = torch.where(nomatch & g_plus_in, c + 1, INF)
        c_dm1 = torch.cat([inf, c[:, :-1]], dim=1)
        rskip = torch.where(nomatch, c_dm1 + 1, INF)
        c_row = torch.minimum(torch.minimum(diag, sub), rskip)
        gskip_ok = nomatch & g_plus_in
        for _ in range(3):
            up = torch.cat([c_row[:, 1:], inf], dim=1)
            c_row = torch.where(gskip_ok, torch.minimum(c_row, up + 1),
                                c_row)
        in_accept = r >= rlen
        c_row = torch.where(in_accept, 0, c_row)

        take_sub = nomatch & g_plus_in & (c == c_row - 1)
        up = torch.cat([c_row[:, 1:], inf], dim=1)
        take_gskip = nomatch & ~take_sub & gskip_ok & (up == c_row - 1)
        take_rskip = nomatch & ~take_sub & ~take_gskip & \
            (c_dm1 == c_row - 1)
        a_dm1 = torch.cat([invalid, a[:, :-1]], dim=1)
        a_row = torch.where(match | take_sub, a,
                            torch.where(take_rskip, a_dm1, INVALID_A))
        for _ in range(4):
            a_up = torch.cat([a_row[:, 1:], invalid], dim=1)
            a_row = torch.where(take_gskip, a_up, a_row)
        a_row = torch.where(in_accept, d_off, a_row)
        c, a = c_row, a_row
    return c, a
