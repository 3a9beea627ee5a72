// Banded short-read extension DP for Hopper (sm_90a): kernels K1 to K4.
//
// Replaces the TPU kernels of gaml_tpu/ops/extend_pallas.py:
//   K1  swar_cost_pallas         (_swar_kernel_dyn, forward direction, cost)
//   K2  swar_cost_accept_pallas  (_swar_kernel_acc_dyn, backward direction,
//                                 cost plus preferred accept offset)
//   K3  dp_rows_pallas_reg_dyn   (_dp_kernel_reg_dyn: exact cost and offset,
//                                 register band, per-block row bound)
//   K4a dp_rows_pallas           (_dp_kernel: exact cost and offset over all
//                                 rmax rows, sublane band)
//   K4b dp_rows_pallas_reg       (_dp_kernel_reg: K4a in a register band)
// K3, K4a and K4b differ only in TPU layout and row bound, so they share
// one entry point here, gaml_dp_rows_exact.  tools/swar_kernel_proto.py's
// prototype (K6) computes K1's function; its port runs gaml_swar_cost.
// All compute the exact recurrence of gaml_tpu.ops.extend._dp_rows (its
// torch twin is gaml_tpu_torch.ops.extend.dp_rows): a min-plus DP over
// read rows on the 7 diagonals d in [-3, 3], run downward from the row
// bound.  Moves per row: match on the diagonal (the last genome char only
// if it ends the read), substitution, read-skip to d-1, genome-skip to
// d+1 (relaxed three times).  The accept offset follows the BFS
// tie-break: match keeps, then substitution, then genome-skip, then
// read-skip.
//
// Design.  One thread per candidate.  Inputs are candidate-minor uint8
// (read_t [rmax, n], gwin_t [rmax + 2*PAD, n]), so every row's loads are
// coalesced across a warp.  Each thread loops r = min(rlen, rmax)-1 .. 0:
// rows >= rlen are accept rows equal to the initial state, so skipping
// them is exact, and the per-thread bound replaces the TPU's per-block
// bound, its r0 sort and its tile permutation.  The band lives in
// registers as seven exact int32 costs (and seven offsets for K2 and the
// exact entry point); a
// rolling 7-char genome window needs one new byte per row.  The TPU
// kernels packed the band into 4-bit SWAR fields saturating at 7; these
// kernels keep exact costs and saturate only the output, so K1 returns
// min(c_exact, 7) and K2 additionally returns the exact offset
// everywhere (the contract asks for it where c_exact <= 6).  The exact
// entry point (K3/K4) stores c and a unsaturated: c is at most INF = 100,
// since every move's cost is capped at INF as in dp_rows.  The epilogue
// (ok, errs, begin, the g0 == 0 rule) is left to torch
// (gaml_tpu_torch.ops.extend.extend_epilogue).
//
// What bounds it on an H100: integer ALU work and the dependency chain of
// the row recurrence (about 60-120 integer ops per candidate-row, serial
// over rows), with about 2 B loaded per candidate-row and occupancy from
// roughly 1e5 threads per rescore.  Warps diverge on ragged row bounds;
// sorting candidates by r0 for warp-uniform bounds, fusing the staging
// gathers from the resident read codes, and a packed band are later work.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBand = 7;
constexpr int kInf = 100;
constexpr int kInvalidA = 100;
constexpr int kSat = 7;
constexpr int kThreads = 128;

template <bool kAccept, bool kSaturate>
__global__ void __launch_bounds__(kThreads)
band_dp_kernel(const uint8_t* __restrict__ read_t,
               const uint8_t* __restrict__ gwin_t,
               const int32_t* __restrict__ rlen,
               const int32_t* __restrict__ glen, int n, int rmax,
               int32_t* __restrict__ c_out, int32_t* __restrict__ a_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const size_t stride = static_cast<size_t>(n);
  const int rl = rlen[i];
  const int gl = glen[i];
  const int rows = max(0, min(rl, rmax));

  int c[kBand];
  int a[kBand];
  uint8_t ch[kBand];  // ch[d] = gwin[r + d + 1]: genome char on diagonal d
#pragma unroll
  for (int d = 0; d < kBand; ++d) {
    c[d] = 0;
    a[d] = d - 3;
    ch[d] = 0;
  }
  if (rows > 0) {
#pragma unroll
    for (int d = 0; d < kBand; ++d) ch[d] = gwin_t[(rows + d) * stride + i];
  }

  for (int r = rows - 1; r >= 0; --r) {
    const uint8_t rc = read_t[r * stride + i];
    const bool last_row = r + 1 == rl;
    bool match[kBand];
    bool gpi[kBand];  // the genome char after this diagonal's is in range
    int crow[kBand];
#pragma unroll
    for (int d = 0; d < kBand; ++d) {
      match[d] = ch[d] == rc;
      gpi[d] = r + d - 2 < gl;
      int v = kInf;
      if (match[d]) {
        if (gpi[d] || last_row) v = c[d];
      } else {
        if (gpi[d]) v = min(v, c[d] + 1);                  // substitution
        v = min(v, (d > 0 ? c[d - 1] : kInf) + 1);         // read-skip
      }
      crow[d] = v;
    }
    // genome-skip within the row, three Jacobi sweeps (ascending d reads
    // crow[d + 1] before this sweep updates it)
#pragma unroll
    for (int it = 0; it < 3; ++it) {
#pragma unroll
      for (int d = 0; d < kBand; ++d) {
        if (!match[d] && gpi[d]) {
          const int up = d + 1 < kBand ? crow[d + 1] : kInf;
          crow[d] = min(crow[d], up + 1);
        }
      }
    }
    if (kAccept) {
      int arow[kBand];
      bool take_gskip[kBand];
#pragma unroll
      for (int d = 0; d < kBand; ++d) {
        const bool nm = !match[d];
        const bool take_sub = nm && gpi[d] && c[d] == crow[d] - 1;
        const int up = d + 1 < kBand ? crow[d + 1] : kInf;
        take_gskip[d] = nm && !take_sub && gpi[d] && up == crow[d] - 1;
        const int dm1 = d > 0 ? c[d - 1] : kInf;
        const bool take_rskip =
            nm && !take_sub && !take_gskip[d] && dm1 == crow[d] - 1;
        if (match[d] || take_sub) {
          arow[d] = a[d];
        } else if (take_rskip) {
          arow[d] = d > 0 ? a[d - 1] : kInvalidA;
        } else {
          arow[d] = kInvalidA;
        }
      }
#pragma unroll
      for (int it = 0; it < 4; ++it) {
#pragma unroll
        for (int d = 0; d < kBand; ++d) {
          if (take_gskip[d]) arow[d] = d + 1 < kBand ? arow[d + 1] : kInvalidA;
        }
      }
#pragma unroll
      for (int d = 0; d < kBand; ++d) a[d] = arow[d];
    }
#pragma unroll
    for (int d = 0; d < kBand; ++d) c[d] = crow[d];
    if (r > 0) {
#pragma unroll
      for (int d = kBand - 1; d > 0; --d) ch[d] = ch[d - 1];
      ch[0] = gwin_t[r * stride + i];
    }
  }
  c_out[i] = kSaturate ? min(c[3], kSat) : c[3];
  if (kAccept) a_out[i] = a[3];
}

int launch_blocks(int n) { return (n + kThreads - 1) / kThreads; }

}  // namespace

// K1: forward direction, cost only.  All pointers are device pointers;
// the launch goes on ``stream`` and does not synchronise.  Returns
// cudaGetLastError() after the launch.
extern "C" int gaml_swar_cost(const void* read_t, const void* gwin_t,
                              const void* rlen, const void* glen, int n,
                              int rmax, void* c_out, void* stream) {
  band_dp_kernel<false, true><<<launch_blocks(n), kThreads, 0,
                                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(read_t), static_cast<const uint8_t*>(gwin_t),
      static_cast<const int32_t*>(rlen), static_cast<const int32_t*>(glen), n,
      rmax, static_cast<int32_t*>(c_out), nullptr);
  return static_cast<int>(cudaGetLastError());
}

// K2: backward direction, cost plus accept offset.
extern "C" int gaml_swar_cost_accept(const void* read_t, const void* gwin_t,
                                     const void* rlen, const void* glen,
                                     int n, int rmax, void* c_out,
                                     void* a_out, void* stream) {
  band_dp_kernel<true, true><<<launch_blocks(n), kThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(read_t), static_cast<const uint8_t*>(gwin_t),
      static_cast<const int32_t*>(rlen), static_cast<const int32_t*>(glen), n,
      rmax, static_cast<int32_t*>(c_out), static_cast<int32_t*>(a_out));
  return static_cast<int>(cudaGetLastError());
}

// K3/K4a/K4b: exact (unsaturated) cost plus accept offset of the start
// state, for any n and rmax.
extern "C" int gaml_dp_rows_exact(const void* read_t, const void* gwin_t,
                                  const void* rlen, const void* glen, int n,
                                  int rmax, void* c_out, void* a_out,
                                  void* stream) {
  band_dp_kernel<true, false><<<launch_blocks(n), kThreads, 0,
                                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(read_t), static_cast<const uint8_t*>(gwin_t),
      static_cast<const int32_t*>(rlen), static_cast<const int32_t*>(glen), n,
      rmax, static_cast<int32_t*>(c_out), static_cast<int32_t*>(a_out));
  return static_cast<int>(cudaGetLastError());
}
