// Banded short-read extension DP for Hopper (sm_90a): kernels K1 to K4 and
// the fused two-direction extension.
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
// gaml_extend_fused runs K2's function (backward) and then K1's (forward)
// for each candidate of a resident read set, with the gathers and the
// epilogue inside: it is what the short-read rescore launches for K1 + K2.
//
// All compute the exact recurrence of gaml_tpu.ops.extend._dp_rows (its
// torch twin is gaml_tpu_torch.ops.extend.dp_rows): a min-plus DP over
// read rows on the 7 diagonals d in [-3, 3], run downward from the row
// bound.  Moves per row: match on the diagonal (the last genome char only
// if it ends the read), substitution, read-skip to d-1, genome-skip to
// d+1 (relaxed three times).  The accept offset follows the BFS
// tie-break: match keeps, then substitution, then genome-skip, then
// read-skip.
//
// Design.  One thread per candidate, looping its own rows r =
// min(rlen, rmax)-1 .. 0: rows >= rlen are accept rows equal to the
// initial state, so skipping them is exact, and the per-thread bound
// replaces the TPU's per-block bound, its r0 sort and its tile
// permutation.  The band is packed: the 7 diagonals (and one padding lane
// held at INF) are 16-bit lanes of four 32-bit words, as are the accept
// offsets and the genome chars on the diagonals.  Every cost is at most
// INF = 100, so a lane holds the exact cost (the TPU kernels packed 4-bit
// fields saturating at 7).  A row is one band_row(): per word, the
// substitution and read-skip relaxations are __viaddmin_s16x2 (an add and
// a min on both lanes: Hopper's DPX instructions), the three genome-skip
// sweeps one __byte_perm (the neighbour diagonal) and one __viaddmin_s16x2
// each, the selects one LOP3; every lane test (char match, genome bound,
// the accept offset's tie-break) is one add and one byte permute that
// spreads the sign bit of each lane (the emulated __vcmpeq2 cost several
// times that).  The staged entries (K1, K2, exact) read
// candidate-minor uint8 inputs (read_t [rmax, n], gwin_t [rmax + 2*PAD,
// n]); the fused entry reads the resident read codes [rows, L] and the
// window buffer directly, with a bounds test in place of the staged
// sentinels (no clamped index, ROADMAP C1).  A rolling window of the 7
// genome chars needs one new byte per row.
//
// What bounds it on an H100: integer work on the dependency chain of the
// row recurrence, serial over rows: 12 operations per 16-bit lane and
// row for the cost and 12 more for the accept offset, two lanes per DPX
// or LOP3 instruction; the bytes (one read byte and one genome byte per
// candidate-row, from L1 after the first touch of a sector) take about
// a tenth of that time.  chip_smoke.py prints each kernel's bound from
// these counts beside its time, and checks that the SASS of every band
// kernel holds DPX instructions (VIADDMNMX.S16x2) and no spill.
//
// The fused entry (gaml_extend_fused) is what the short-read rescore
// launches: one launch per batch, where the staged route made about 20
// torch launches of staging (with a padded copy of the window buffer)
// and two kernel launches, and cost about seven times the fused kernel
// on the card.  One thread runs both directions of its candidate, L - K
// rows in all, so the threads of a warp of a uniform read set stay
// together (each staged kernel ran about rmax rows per warp for about
// rmax / 2 of use).  Each row's read code and rolled-in genome byte are
// loaded one row ahead, per byte through L1; a warp-wide copy of the
// read rows and genome views into shared memory first was slower on the
// H100 (PERF.md).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kSat = 7;
constexpr int kK = 15;             // seed k-mer length
constexpr int kPad = 4;            // staged window padding
constexpr int kErrorLimit = 3;
constexpr uint8_t kSentGen = 8;    // out-of-genome sentinel
constexpr int kThreads = 128;

constexpr uint32_t kInf2 = 0x00640064u;      // INF (and INVALID_A) in both lanes
constexpr uint32_t kOne2 = 0x00010001u;
constexpr uint32_t kLoLane = 0x0000FFFFu;
constexpr uint32_t kPadChar = 0x00FF0000u;   // lane 7's genome char: no code

// (a where m, else b), lanewise; one LOP3
__device__ __forceinline__ uint32_t sel(uint32_t m, uint32_t a, uint32_t b) {
  return (a & m) | (b & ~m);
}

// lane j of the result is lane j+1 of the lane pair (lo, hi) of two words:
// the next diagonal's value, or (with lo = word k-1, hi = word k) the
// previous diagonal's
__device__ __forceinline__ uint32_t next_lane(uint32_t lo, uint32_t hi) {
  return __byte_perm(lo, hi, 0x5432);
}

// each 16-bit lane filled with its top bit (prmt's sign-replicate mode)
__device__ __forceinline__ uint32_t lane_mask(uint32_t x) {
  uint32_t r;
  asm("prmt.b32 %0, %1, %2, %3;" : "=r"(r) : "r"(x), "r"(0u), "r"(0xBB99u));
  return r;
}

__device__ __forceinline__ int lane3(uint32_t w1) {
  return static_cast<int>(static_cast<int16_t>(w1 >> 16));
}

// The packed band: word k holds diagonals 2k (low lane) and 2k+1 (high
// lane); lane 7 is padding (cost INF, offset INVALID_A, char 0xFF).
struct Band {
  uint32_t c[4];  // costs
  uint32_t a[4];  // accept offsets (int16 lanes)
  uint32_t g[4];  // genome chars on the diagonals
};

__device__ __forceinline__ void band_init(Band& b) {
  b.c[0] = 0u;
  b.c[1] = 0u;
  b.c[2] = 0u;
  b.c[3] = 0x00640000u;
  b.a[0] = 0xFFFEFFFDu;  // -3, -2
  b.a[1] = 0x0000FFFFu;  // -1, 0
  b.a[2] = 0x00020001u;  // 1, 2
  b.a[3] = 0x00640003u;  // 3, INVALID_A
}

// One read row: ``rc`` the read code in both lanes, diagonals d < ``t``
// have the next genome char in range, ``last`` the row ends the read.
// Lane tests run on values of at most INF + 1, with 0x8000 added so that
// no lane borrows from the next: bit 15 of (x + 0x8000 - y) is x >= y,
// and lane_mask() turns that bit into the lane's mask.
template <bool kAccept>
__device__ __forceinline__ void band_row(Band& b, uint32_t rc, uint32_t t,
                                         bool last) {
  // 0x8000 + d for the diagonals d of each word
  const uint32_t dvec[4] = {0x80018000u, 0x80038002u, 0x80058004u,
                            0x80078006u};
  const uint32_t t2 = t * kOne2;
  const uint32_t last_m = last ? 0xFFFFFFFFu : 0u;
  uint32_t match[4], nm[4], gpi[4], cm1[4], crow[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    nm[k] = lane_mask((b.g[k] ^ rc) + 0x7FFF7FFFu);  // chars differ
    match[k] = ~nm[k];
    gpi[k] = ~lane_mask(dvec[k] - t2);  // d < t
    cm1[k] = next_lane(k ? b.c[k - 1] : kInf2, b.c[k]);
  }
  nm[3] &= kLoLane;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const uint32_t diag = sel(gpi[k] | last_m, b.c[k], kInf2);
    const uint32_t rskip = __viaddmin_s16x2(cm1[k], kOne2, kInf2);
    const uint32_t mis = __viaddmin_s16x2(sel(gpi[k], b.c[k], kInf2), kOne2,
                                          rskip);
    crow[k] = sel(match[k], diag, mis);
  }
  crow[3] = (crow[3] & kLoLane) | (kInf2 & ~kLoLane);
  uint32_t gk[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) gk[k] = nm[k] & gpi[k];
  // genome-skip within the row: three Jacobi sweeps
#pragma unroll
  for (int it = 0; it < 3; ++it) {
    uint32_t up[4];
#pragma unroll
    for (int k = 0; k < 4; ++k)
      up[k] = next_lane(crow[k], k < 3 ? crow[k + 1] : kInf2);
#pragma unroll
    for (int k = 0; k < 4; ++k)
      crow[k] = sel(gk[k], __viaddmin_s16x2(up[k], kOne2, crow[k]), crow[k]);
  }
  if (kAccept) {
    // The tie-break takes the move whose source cost is crow - 1.  A
    // substitution's source c and a read-skip's cm1 are never below
    // crow - 1 (crow is their min plus one, capped at INF), so for them
    // the test is c < crow; the genome-skip's source (the final crow of
    // d + 1) may lie below after three sweeps, so it is tested both ways.
    uint32_t tg[4], arow[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const uint32_t up = next_lane(crow[k], k < 3 ? crow[k + 1] : kInf2);
      const uint32_t ts = gk[k] & ~(b.c[k] + 0x80008000u - crow[k]);
      const uint32_t tgs = gk[k] & ~ts & (crow[k] + 0x7FFF7FFFu - up) &
                           (up + 0x80018001u - crow[k]);
      const uint32_t tr =
          nm[k] & ~(ts | tgs | (cm1[k] + 0x80008000u - crow[k]));
      tg[k] = lane_mask(tgs);
      const uint32_t am1 = next_lane(k ? b.a[k - 1] : kInf2, b.a[k]);
      arow[k] = sel(match[k] | lane_mask(ts), b.a[k],
                    sel(lane_mask(tr), am1, kInf2));
    }
#pragma unroll
    for (int it = 0; it < 4; ++it) {
      uint32_t aup[4];
#pragma unroll
      for (int k = 0; k < 4; ++k)
        aup[k] = next_lane(arow[k], k < 3 ? arow[k + 1] : kInf2);
#pragma unroll
      for (int k = 0; k < 4; ++k) arow[k] = sel(tg[k], aup[k], arow[k]);
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) b.a[k] = arow[k];
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) b.c[k] = crow[k];
}

// Shift the genome chars one diagonal up (the next row is one lower) and
// put ``ch`` on diagonal 0.
__device__ __forceinline__ void band_roll(Band& b, uint32_t ch) {
  b.g[3] = __byte_perm(b.g[2], kPadChar, 0x7632);
  b.g[2] = next_lane(b.g[1], b.g[2]);
  b.g[1] = next_lane(b.g[0], b.g[1]);
  b.g[0] = __byte_perm(ch, b.g[0], 0x5410);
}

// The genome chars of the band's first row: diagonal d of row rows - 1
// holds gen(rows + d).
template <class Gen>
__device__ __forceinline__ void band_chars(Band& b, int rows, Gen gen) {
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const uint32_t lo = gen(rows + 2 * k);
    const uint32_t hi = k < 3 ? gen(rows + 2 * k + 1) : 0xFFu;
    b.g[k] = lo | (hi << 16);
  }
}

// The band from the initial state down to row 0: ``read(r)`` is the read
// code at row r, ``gen(i)`` the genome char at window index i (the char
// of diagonal d at row r is gen(r + d + 1)); ``rl``/``gl`` the read and
// genome lengths of the direction.
template <bool kAccept, class Read, class Gen>
__device__ __forceinline__ void run_band(Band& b, int rows, int rl, int gl,
                                         Read read, Gen gen) {
  band_init(b);
  if (rows <= 0) return;
  band_chars(b, rows, gen);
  for (int r = rows - 1; r >= 0; --r) {
    const uint32_t t = static_cast<uint32_t>(min(max(gl - r + 2, 0), 8));
    band_row<kAccept>(b, read(r) * kOne2, t, r + 1 == rl);
    if (r > 0) band_roll(b, gen(r));
  }
}

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
  Band b;
  run_band<kAccept>(
      b, max(0, min(rl, rmax)), rl, glen[i],
      [&](int r) -> uint32_t { return read_t[r * stride + i]; },
      [&](int j) -> uint32_t { return gwin_t[j * stride + i]; });
  const int c = lane3(b.c[1]);
  c_out[i] = kSaturate ? min(c, kSat) : c;
  if (kAccept) a_out[i] = lane3(b.a[1]);
}

// The genome char at window index j of the backward view (the reversed
// genome prefix: position g - 1 - (j - PAD), sentinels in the first PAD
// indices) and of the forward view (position g + K - PAD + j), with a
// bounds test where the staged views have sentinels.
__device__ __forceinline__ uint32_t gen_backward(const uint8_t* gw, int g,
                                                 int j) {
  const int p = g + kPad - 1 - j;
  return j >= kPad && p >= 0 ? gw[p] : kSentGen;
}

__device__ __forceinline__ uint32_t gen_forward(const uint8_t* gw, int g,
                                                int gl, int j) {
  const int p = g + kK - kPad + j;
  return p >= 0 && p < gl ? gw[p] : kSentGen;
}

// Both directions of one candidate and the epilogue.  ``rd(j)`` is byte j
// of its read row, ``gb(j)``/``gf(j)`` the backward/forward genome views.
// One loop runs the backward direction's rows (K2's function: the
// reversed read prefix against the reversed genome prefix, cost and
// accept offset) and then the forward direction's (K1's: the read suffix
// after the seed against the genome from the seed end), so a thread makes
// L - K iterations whatever its seed's offset r0 and the threads of a
// warp stay together.  The forward rows compute an accept offset nobody
// reads: seed offsets differ across a warp, so in almost every iteration
// some of its lanes are still in their backward rows, and a cost-only
// branch (or skipping the offset's part of the row) would leave the warp
// running both forms.  Both were slower on the H100 in a probe of
// variants of this file (PERF.md).
template <class Rd, class Gb, class Gf>
__device__ __forceinline__ void extend_one(int L, int rmax, int gl, int g,
                                           int s, Rd rd, Gb gb, Gf gf,
                                           uint8_t* ok_out, int32_t* errs_out,
                                           int32_t* begin_out) {
  const int rl_b = g > 0 ? s : 0;
  const int rows_b = min(rl_b, rmax);
  const int rl_f = L - s - kK;
  const int rows_f = max(0, min(rl_f, rmax));
  const int gl_f = gl - g - kK;
  Band b;
  band_init(b);
  if (rows_b > 0) {
    band_chars(b, rows_b, gb);
  } else if (rows_f > 0) {
    band_chars(b, rows_f, gf);
  }
  int cb = 0;  // the backward cost and offset of an empty direction
  int ab = 0;
  const int total = rows_b + rows_f;
  // iteration k's row, read code and rolled-in genome char (none on a
  // direction's row 0); each is loaded one iteration ahead, so its
  // latency hides behind the row before it
  auto row_of = [&](int k) {
    return k < rows_b ? rows_b - 1 - k : total - 1 - k;
  };
  auto code_at = [&](int k) -> uint32_t {
    const int r = row_of(k);
    return k < rows_b ? rd(s - 1 - r) : rd(s + kK + r);
  };
  auto char_at = [&](int k) -> uint32_t {
    const int r = row_of(k);
    return r == 0 ? 0u : k < rows_b ? gb(r) : gf(r);
  };
  uint32_t rc = total > 0 ? code_at(0) : 0u;
  uint32_t ch = total > 0 ? char_at(0) : 0u;
  for (int k = 0; k < total; ++k) {
    const bool more = k + 1 < total;
    const uint32_t rc_next = more ? code_at(k + 1) : 0u;
    const uint32_t ch_next = more ? char_at(k + 1) : 0u;
    const bool back = k < rows_b;
    const int r = row_of(k);
    const int lim = (back ? g : gl_f) - r + 2;
    band_row<true>(b, rc * kOne2,
                   static_cast<uint32_t>(min(max(lim, 0), 8)),
                   r + 1 == (back ? rl_b : rl_f));
    if (r > 0) {
      band_roll(b, ch);
    } else if (back) {  // the backward direction is done: start the forward
      cb = lane3(b.c[1]);
      ab = lane3(b.a[1]);
      band_init(b);
      if (rows_f > 0) band_chars(b, rows_f, gf);
    }
    rc = rc_next;
    ch = ch_next;
  }
  const int cf = lane3(b.c[1]);
  bool ok = cf <= kErrorLimit && cb <= kErrorLimit;
  int errs = cf + cb;
  int begin = g - s - ab;
  if (g == 0) {  // a seed at genome position 0 (graph.cc:797-798)
    ok = ok && s < 6;
    errs += s;
    begin = -1;
  }
  *ok_out = ok;
  *errs_out = errs;
  *begin_out = begin;
}

// Both directions of each candidate of a resident read set, then the
// epilogue (ok, errs, begin), as ops.extend.stage_views + dp_rows +
// extend_epilogue compute them.  Each thread loads its bytes from device
// memory (through L1) as the rows need them.
__global__ void __launch_bounds__(kThreads)
extend_fused_kernel(const uint8_t* __restrict__ codes,
                    const uint8_t* __restrict__ buf,
                    const int32_t* __restrict__ base,
                    const int32_t* __restrict__ glen,
                    const int32_t* __restrict__ g0,
                    const int32_t* __restrict__ r0,
                    const int32_t* __restrict__ row, int n, int L, int rmax,
                    uint8_t* __restrict__ ok_out,
                    int32_t* __restrict__ errs_out,
                    int32_t* __restrict__ begin_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int gl = glen[i];
  const int g = g0[i];
  const uint8_t* rd = codes + static_cast<size_t>(row[i]) * L;
  const uint8_t* gw = buf + base[i];
  extend_one(
      L, rmax, gl, g, r0[i], [&](int j) -> uint32_t { return rd[j]; },
      [&](int j) { return gen_backward(gw, g, j); },
      [&](int j) { return gen_forward(gw, g, gl, j); }, ok_out + i,
      errs_out + i, begin_out + i);
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

// K1 + K2 fused: both directions and the epilogue for n candidates of a
// resident read set.  codes [rows, L] uint8; buf [G] uint8; base, glen,
// g0, r0, row [n] int32; outputs ok uint8 [n], errs and begin int32 [n].
extern "C" int gaml_extend_fused(const void* codes, const void* buf,
                                 const void* base, const void* glen,
                                 const void* g0, const void* r0,
                                 const void* row, int n, int L, int rmax,
                                 void* ok_out, void* errs_out,
                                 void* begin_out, void* stream) {
  extend_fused_kernel<<<launch_blocks(n), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(codes), static_cast<const uint8_t*>(buf),
      static_cast<const int32_t*>(base), static_cast<const int32_t*>(glen),
      static_cast<const int32_t*>(g0), static_cast<const int32_t*>(r0),
      static_cast<const int32_t*>(row), n, L, rmax,
      static_cast<uint8_t*>(ok_out), static_cast<int32_t*>(errs_out),
      static_cast<int32_t*>(begin_out));
  return static_cast<int>(cudaGetLastError());
}
