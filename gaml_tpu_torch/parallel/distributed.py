"""Multi-process scoring over torch.distributed.

Port of gaml_tpu/parallel/distributed.py.  The recipe is the JAX
package's (SURVEY.md section 5.8):

- every process calls :func:`initialize` with the coordinator address;
- the read set is split by process (reads_for_process): each process
  scores only its own contiguous range of reads (its device state holds
  only their totals, its staging only their rows, its PacBio forward DP
  only their jobs);
- the annealing driver runs replicated on every process (same seed, same
  move stream), so walk sets never need broadcasting.

Where the JAX mesh psum-merges partial sums, the port gathers: each
process computes its own reads' per-read totals in the one-process
order, ``gather_read_values`` assembles the full vector in rank order,
and every process runs the one-process reduction on it.  A merged score
is then bit-equal to a world of one on the same device type and the
same on every rank, so the replicated anneals cannot drift apart (a
per-read total can be pure rounding residue; another order of addition
changes accepts).

Collectives are ``all_gather`` and ``all_reduce`` only (gloo has no
reduce_scatter).  Under gloo a CUDA tensor goes through host memory
explicitly (``_to_comm``): gloo's CUDA support differs from collective
to collective.  The scoring stays on each process's device.  NCCL needs
one card per rank; ranks that share a card run gloo.

Environment (the JAX module's names):

    GAML_COORD=host0:8476 GAML_NUM_PROCS=2 GAML_PROC_ID=$RANK python run.py
"""
from __future__ import annotations

import datetime
import os
from typing import List, Optional, Tuple

import numpy as np
import torch

# a rank that is lost fails its peers' collectives after this long instead
# of hanging them
TIMEOUT_S = 600


def initialize(coordinator: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               backend: Optional[str] = None,
               device="cuda") -> Tuple[int, int]:
    """Initialize the default process group from the arguments or the
    GAML_* environment variables; a no-op without a coordinator.
    ``backend`` defaults to nccl for a CUDA ``device`` and gloo for the
    CPU.  Returns (process_id, num_processes)."""
    coordinator = coordinator or os.environ.get("GAML_COORD", "")
    if not coordinator:
        return 0, 1
    num_processes = num_processes or int(os.environ.get("GAML_NUM_PROCS",
                                                        "1"))
    process_id = process_id if process_id is not None else \
        int(os.environ.get("GAML_PROC_ID", "0"))
    dev = torch.device(device)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if backend == "nccl":
        n_cards = torch.cuda.device_count()
        if num_processes > n_cards:
            raise ValueError(
                f"NCCL needs one card per rank: {num_processes} ranks on "
                f"{n_cards} card(s); ranks that share a card need "
                "backend gloo (GAML_DIST_BACKEND=gloo)")
        torch.cuda.set_device(rank_device(dev, process_id))
    torch.distributed.init_process_group(
        backend=backend, init_method=f"tcp://{coordinator}",
        world_size=num_processes, rank=process_id,
        timeout=datetime.timedelta(seconds=TIMEOUT_S))
    return process_id, num_processes


def shutdown() -> None:
    """Destroy the default process group, if there is one."""
    if torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()


def rank_device(device, process_id: int) -> torch.device:
    """This rank's device: ``cuda`` is cuda:{process_id % cards}, an
    explicit index is kept, the CPU stays the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", process_id % torch.cuda.device_count())
    return dev


def world() -> Tuple[int, int]:
    """(rank, size) of the default process group; (0, 1) without one."""
    if torch.distributed.is_initialized():
        return torch.distributed.get_rank(), torch.distributed.get_world_size()
    return 0, 1


def reads_for_process(n_reads: int, process_id: int,
                      num_processes: int) -> List[int]:
    """Deterministic contiguous read partition for one process."""
    per = (n_reads + num_processes - 1) // num_processes
    lo = process_id * per
    hi = min(n_reads, lo + per)
    return list(range(lo, hi))


def read_range(n_reads: int) -> Tuple[int, int]:
    """This process's reads as [lo, hi) (reads_for_process's partition;
    empty ranges sit at n_reads)."""
    rank, size = world()
    per = (n_reads + size - 1) // size
    lo = min(n_reads, rank * per)
    return lo, min(n_reads, lo + per)


def _to_comm(t: torch.Tensor) -> torch.Tensor:
    """``t`` where the backend's collectives take it: this rank's card
    under nccl, host memory under gloo (a CUDA tensor staged through it
    explicitly)."""
    if torch.distributed.get_backend() == "nccl":
        return t.to(torch.device("cuda", torch.cuda.current_device()))
    return t.cpu()


def all_gather(t: torch.Tensor) -> List[torch.Tensor]:
    """Every rank's ``t`` (same shape on every rank), in rank order, on
    ``t``'s device."""
    c = _to_comm(t.contiguous())
    out = [torch.empty_like(c) for _ in range(world()[1])]
    torch.distributed.all_gather(out, c)
    return [o.to(t.device) for o in out]


def all_reduce_max(t: torch.Tensor) -> torch.Tensor:
    """The element-wise max of every rank's ``t``; ``t`` itself without a
    process group."""
    if not torch.distributed.is_initialized():
        return t
    c = _to_comm(t.contiguous())
    torch.distributed.all_reduce(c, op=torch.distributed.ReduceOp.MAX)
    return c.to(t.device)


def combine_partials(local_log_sum: float, local_zero: int,
                     local_count: int):
    """All-gather per-process partial sums (float64 [3]) and combine them
    into the global (log_sum, zero_reads, count), summed in rank order;
    score = log_sum / count.  Works unchanged in single-process runs."""
    arr = torch.tensor([local_log_sum, float(local_zero), float(local_count)],
                       dtype=torch.float64)
    if torch.distributed.is_initialized():
        arr = torch.stack(all_gather(arr))
    g = arr.reshape(-1, 3).numpy()
    return (float(g[:, 0].sum()), int(g[:, 1].sum()), int(g[:, 2].sum()))


def gather_read_values(local: torch.Tensor, n_reads: int) -> torch.Tensor:
    """The full per-read vector [n_reads] from each rank's contiguous
    slice (read_range), in rank order, on ``local``'s device; ``local``
    itself without a process group."""
    if not torch.distributed.is_initialized():
        return local
    rank, size = world()
    lo, hi = read_range(n_reads)
    if local.shape[0] != hi - lo:
        raise ValueError(f"rank {rank} holds {local.shape[0]} values of "
                         f"reads [{lo}, {hi})")
    per = (n_reads + size - 1) // size
    pad = local.new_zeros((per,) + tuple(local.shape[1:]))
    pad[:hi - lo] = local
    return torch.cat(all_gather(pad))[:n_reads]


def gather_rows(local: np.ndarray) -> np.ndarray:
    """Every rank's int64 rows [m_r, k] stacked in rank order (the row
    counts may differ); ``local`` itself without a process group."""
    if not torch.distributed.is_initialized():
        return local
    local = np.ascontiguousarray(local, dtype=np.int64)
    counts = all_gather(torch.tensor([len(local)], dtype=torch.int64))
    counts = [int(c) for c in counts]
    pad = np.zeros((max(counts),) + local.shape[1:], np.int64)
    pad[:len(local)] = local
    parts = all_gather(torch.from_numpy(pad))
    return np.concatenate([p.numpy()[:c] for p, c in zip(parts, counts)])
