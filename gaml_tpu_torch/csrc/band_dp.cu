// Banded short-read extension DP for Hopper (sm_90a): kernels K1 to K4
// and the exact two-direction extension.
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
// K3, K4a and K4b differ only in TPU layout and row bound; what their
// callers compute with them is both directions of a seed candidate and the
// epilogue (gaml_tpu/ops/extend_pallas.py::extend_kernel_pallas,
// gaml_tpu/ops/score.py), and that is one entry here in two loaders:
// gaml_extend_exact (a resident read set of any read lengths: the
// short-read rescore, the models' host candidates, the batch helpers, the
// mixed-length aligner) and gaml_extend_exact_staged (the staged dict of
// the single-end model's forward step, read where it lies).  The rescore's
// K2 (backward) and K1 (forward) are the same two directions with the
// offset read from the backward one and the costs saturated at 7, so
// gaml_extend_exact serves them too.  gaml_swar_cost, gaml_swar_cost_accept
// and gaml_dp_rows_exact keep the single-direction contracts of the TPU
// kernels as an API (the staged route's yardstick; gaml_swar_cost runs the
// K6 prototype of tools/swar_kernel_proto.py, which computes K1's
// function).
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
// times that).  The single-direction entries (K1, K2, dp_rows_exact) read
// candidate-minor uint8 inputs (read_t [rmax, n], gwin_t [rmax + 2*PAD,
// n]).  The two-direction entries read the resident read codes [rows, L]
// and the window buffer directly, with a bounds test in place of the
// staged sentinels (no clamped index, ROADMAP C1), or each candidate's own
// contiguous rows of a staged dict's candidate-major views.  A rolling
// window of the 7 genome chars needs one new byte per row.
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
// The two-direction entries share one loop (extend_one): one thread runs
// both directions of its candidate, rows_b + rows_f rows in all, with the
// gathers and the epilogue inside: one launch per batch, where the staged
// route made about 20 torch launches of staging and two kernel launches,
// and cost about seven times as much on the card.  Each row's read code
// and rolled-in genome byte are loaded one row ahead, per byte through L1;
// a warp-wide copy of the read rows and genome views into shared memory
// first was slower on the H100 (PERF.md).  Read lengths may be ragged and
// seed offsets differ, so a warp would run the most rows of its lanes in
// each direction.  Each launch first buckets its candidates by (rows_b,
// rows_f) with a counting sort on the card (three small kernels: torch's
// sort cost more than the ordering saved), so that the lanes of a warp run
// as many rows and switch from the backward to the forward direction
// together, and the forward rows then skip the accept offset's half of the
// row's work.  Ordered so, this form beat the unordered one with the
// offset on every row, on uniform and on ragged reads (PERF.md).

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
  return j >= kPad && p >= 0 ? __ldg(gw + p) : kSentGen;
}

__device__ __forceinline__ uint32_t gen_forward(const uint8_t* gw, int g,
                                                int gl, int j) {
  const int p = g + kK - kPad + j;
  return p >= 0 && p < gl ? __ldg(gw + p) : kSentGen;
}

// One candidate of a resident read set: its read row ``rd`` of length L,
// its window ``gw`` of length gl in the window buffer, its seed at g in
// the window and s in the read.  The backward direction is the reversed
// read prefix against the reversed genome prefix (empty for a seed at
// genome position 0), the forward one the read suffix after the seed
// against the genome from the seed end.
struct ResidentCand {
  const uint8_t* rd;
  const uint8_t* gw;
  int g, s, gl, L;
  __device__ int rl_b() const { return g > 0 ? s : 0; }
  __device__ int gl_b() const { return g; }
  __device__ int rl_f() const { return L - s - kK; }
  __device__ int gl_f() const { return gl - g - kK; }
  __device__ bool at_start() const { return g == 0; }
  __device__ uint32_t rb(int r) const { return __ldg(rd + s - 1 - r); }
  __device__ uint32_t rf(int r) const { return __ldg(rd + s + kK + r); }
  __device__ uint32_t gb(int j) const { return gen_backward(gw, g, j); }
  __device__ uint32_t gf(int j) const { return gen_forward(gw, g, gl, j); }
};

// One candidate of a staged dict, read where it lies: its rows of the
// candidate-major views read_b/read_f [nb, rmax] (row r of the direction
// at byte r) and gwin_b/gwin_f [nb, rmax + 2*PAD] (window index j at
// byte j), its direction lengths, seed and genome-start flag.
struct StagedCand {
  const uint8_t* rdb;
  const uint8_t* rdf;
  const uint8_t* gwb;
  const uint8_t* gwf;
  int rlb, glb, rlf, glf, g, s;
  bool start;
  __device__ int rl_b() const { return rlb; }
  __device__ int gl_b() const { return glb; }
  __device__ int rl_f() const { return rlf; }
  __device__ int gl_f() const { return glf; }
  __device__ bool at_start() const { return start; }
  __device__ uint32_t rb(int r) const { return __ldg(rdb + r); }
  __device__ uint32_t rf(int r) const { return __ldg(rdf + r); }
  __device__ uint32_t gb(int j) const { return __ldg(gwb + j); }
  __device__ uint32_t gf(int j) const { return __ldg(gwf + j); }
};

// Both directions of candidate ``c`` of either loader (ResidentCand,
// StagedCand) and the epilogue.  ``c.rb(r)``/``c.rf(r)`` are the read codes
// of row r of the backward/forward direction, ``c.gb(j)``/``c.gf(j)`` the
// genome chars at window index j of the two views; rl_*/gl_* the
// directions' read and genome lengths, c.g/c.s the seed in the window and
// the read, ``at_start`` a seed at genome position 0.  One loop
// runs the backward direction's rows (K2's function: the reversed read
// prefix against the reversed genome prefix, cost and accept offset) and
// then the forward direction's (K1's: the read suffix after the seed
// against the genome from the seed end, the cost), rows_b + rows_f
// iterations in all.  Each row's read code and rolled-in genome char
// (none on a direction's row 0) are loaded one iteration ahead, so their
// latency hides behind the row before them.  The forward rows run the
// cost alone: the entries order their candidates so that the lanes of a
// warp switch direction together (without that order, a warp would run
// both forms of the row, which was slower than the offset everywhere).
template <class C>
__device__ __forceinline__ void extend_one(const C& c, int rmax,
                                           uint8_t* ok_out, int32_t* errs_out,
                                           int32_t* begin_out) {
  const int rl_b = c.rl_b(), gl_b = c.gl_b(), rl_f = c.rl_f(),
            gl_f = c.gl_f();
  const int g = c.g, s = c.s;
  auto gb = [&](int j) { return c.gb(j); };
  auto gf = [&](int j) { return c.gf(j); };
  const int rows_b = max(0, min(rl_b, rmax));
  const int rows_f = max(0, min(rl_f, rmax));
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
  // iteration k's row, read code and rolled-in genome char
  auto row_of = [&](int k) {
    return k < rows_b ? rows_b - 1 - k : total - 1 - k;
  };
  auto code_at = [&](int k) -> uint32_t {
    const int r = row_of(k);
    return k < rows_b ? c.rb(r) : c.rf(r);
  };
  auto char_at = [&](int k) -> uint32_t {
    const int r = row_of(k);
    return r == 0 ? 0u : k < rows_b ? c.gb(r) : c.gf(r);
  };
  uint32_t rc = total > 0 ? code_at(0) : 0u;
  uint32_t ch = total > 0 ? char_at(0) : 0u;
  for (int k = 0; k < total; ++k) {
    const bool more = k + 1 < total;
    const uint32_t rc_next = more ? code_at(k + 1) : 0u;
    const uint32_t ch_next = more ? char_at(k + 1) : 0u;
    const bool back = k < rows_b;
    const int r = row_of(k);
    const uint32_t t = static_cast<uint32_t>(
        min(max((back ? gl_b : gl_f) - r + 2, 0), 8));
    const bool last = r + 1 == (back ? rl_b : rl_f);
    if (back) {
      band_row<true>(b, rc * kOne2, t, last);
    } else {
      band_row<false>(b, rc * kOne2, t, last);
    }
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
  // ok = both costs <= ERROR_LIMIT, errs their sum, begin = g - s - the
  // backward accept offset; a seed at genome position 0 (graph.cc:797-798)
  // accepts iff s < 6, with s more errors and begin -1
  const int cf = lane3(b.c[1]);
  bool ok = cf <= kErrorLimit && cb <= kErrorLimit;
  int errs = cf + cb;
  int begin = g - s - ab;
  if (c.at_start()) {
    ok = ok && s < 6;
    errs += s;
    begin = -1;
  }
  *ok_out = ok;
  *errs_out = errs;
  *begin_out = begin;
}

// The resident loader: read codes [rows, Lc] with each row's read length
// (lens), the window buffer, and each candidate's window offset and
// length, seed and row.
struct ResidentLoad {
  const uint8_t* codes;
  const int32_t* lens;
  const uint8_t* buf;
  const int32_t* base;
  const int32_t* glen;
  const int32_t* g0;
  const int32_t* r0;
  const int32_t* row;
  int Lc;
  __device__ __forceinline__ ResidentCand cand(int i) const {
    const int rw = __ldg(row + i);
    return {codes + static_cast<size_t>(rw) * Lc, buf + __ldg(base + i),
            __ldg(g0 + i), __ldg(r0 + i), __ldg(glen + i),
            __ldg(lens + rw)};
  }
};

// The staged loader: the staged dict's views and per-candidate arrays.
struct StagedLoad {
  const uint8_t* read_f;
  const uint8_t* gwin_f;
  const int32_t* rlen_f;
  const int32_t* glen_f;
  const uint8_t* read_b;
  const uint8_t* gwin_b;
  const int32_t* rlen_b;
  const int32_t* glen_b;
  const int32_t* g0;
  const int32_t* r0;
  const uint8_t* at_start;
  int rmax;
  __device__ __forceinline__ StagedCand cand(int i) const {
    const size_t rd = static_cast<size_t>(i) * rmax;
    const size_t gw = static_cast<size_t>(i) * (rmax + 2 * kPad);
    return {read_b + rd, read_f + rd, gwin_b + gw, gwin_f + gw,
            __ldg(rlen_b + i), __ldg(glen_b + i), __ldg(rlen_f + i),
            __ldg(glen_f + i), __ldg(g0 + i), __ldg(r0 + i),
            __ldg(at_start + i) != 0};
  }
};

// The exact entries: thread t runs candidate order[t] of ``load`` and
// writes its (ok, errs, begin) in place.
template <class Load>
__global__ void __launch_bounds__(kThreads)
extend_kernel(Load load, const int32_t* __restrict__ order, int n, int rmax,
              uint8_t* __restrict__ ok_out, int32_t* __restrict__ errs_out,
              int32_t* __restrict__ begin_out) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n) return;
  const int i = __ldg(order + t);
  extend_one(load.cand(i), rmax, ok_out + i, errs_out + i, begin_out + i);
}

int launch_blocks(int n) { return (n + kThreads - 1) / kThreads; }

// The thread order of an exact launch: the candidates bucketed by their
// (rows_b, rows_f) with a counting sort, so that the lanes of a warp run
// as many rows and switch direction together.  Within a bucket the order
// is whatever the atomics give: it only schedules the threads, and every
// result is written in place.  order_count writes each candidate's key
// and counts the keys, order_scan turns the counts into bucket offsets
// (one block), order_scatter places each candidate at its bucket's next
// slot.
template <class Load>
__global__ void __launch_bounds__(kThreads)
order_count(Load load, int n, int rmax, int32_t* __restrict__ hist,
            int32_t* __restrict__ key) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const auto c = load.cand(i);
  const int k = max(0, min(c.rl_b(), rmax)) * (rmax + 1) +
                max(0, min(c.rl_f(), rmax));
  key[i] = k;
  atomicAdd(hist + k, 1);
}

constexpr int kScanThreads = 1024;

__global__ void __launch_bounds__(kScanThreads)
order_scan(int32_t* __restrict__ hist, int m) {
  __shared__ int32_t part[kScanThreads];
  const int t = threadIdx.x;
  const int per = (m + kScanThreads - 1) / kScanThreads;
  const int lo = min(t * per, m);
  const int hi = min(lo + per, m);
  int sum = 0;
  for (int j = lo; j < hi; ++j) sum += hist[j];
  part[t] = sum;
  __syncthreads();
  for (int d = 1; d < kScanThreads; d <<= 1) {  // inclusive scan
    const int v = t >= d ? part[t - d] : 0;
    __syncthreads();
    part[t] += v;
    __syncthreads();
  }
  int run = part[t] - sum;
  for (int j = lo; j < hi; ++j) {
    const int h = hist[j];
    hist[j] = run;
    run += h;
  }
}

__global__ void __launch_bounds__(kThreads)
order_scatter(const int32_t* __restrict__ key, int n,
              int32_t* __restrict__ next, int32_t* __restrict__ order) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) order[atomicAdd(next + key[i], 1)] = i;
}

// The ints of scratch an exact launch of n candidates with row bound
// rmax needs: the keys, the order, the buckets.
int order_scratch(int n, int rmax) {
  return 2 * n + (rmax + 1) * (rmax + 1);
}

// Order the n candidates of ``load`` into scratch (order_scratch ints);
// returns the order.
template <class Load>
const int32_t* launch_order(const Load& load, int n, int rmax,
                            int32_t* scratch, cudaStream_t s) {
  int32_t* key = scratch;
  int32_t* order = scratch + n;
  int32_t* hist = scratch + 2 * n;
  const int m = (rmax + 1) * (rmax + 1);
  cudaMemsetAsync(hist, 0, sizeof(int32_t) * m, s);
  order_count<<<launch_blocks(n), kThreads, 0, s>>>(load, n, rmax, hist,
                                                    key);
  order_scan<<<1, kScanThreads, 0, s>>>(hist, m);
  order_scatter<<<launch_blocks(n), kThreads, 0, s>>>(key, n, hist, order);
  return order;
}

// The exact entries' launch: the order, then the extension.
template <class Load>
int launch_exact(const Load& load, int n, int rmax, void* scratch,
                 void* ok_out, void* errs_out, void* begin_out,
                 void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const int32_t* order =
      launch_order(load, n, rmax, static_cast<int32_t*>(scratch), s);
  extend_kernel<<<launch_blocks(n), kThreads, 0, s>>>(
      load, order, n, rmax, static_cast<uint8_t*>(ok_out),
      static_cast<int32_t*>(errs_out), static_cast<int32_t*>(begin_out));
  return static_cast<int>(cudaGetLastError());
}

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

// The exact (unsaturated) cost plus accept offset of the start state of
// one direction, for any n and rmax: the contract of the TPU kernels
// K3/K4a/K4b (dp_rows_pallas*), kept as an API and as the K6 tool's
// yardstick; the main paths run the two-direction entries below.
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

// K3/K4a/K4b (and the rescore's K1 + K2) as one exact two-direction
// extension, resident loader: both directions and the epilogue for n
// candidates.  codes [rows, Lc] uint8 with row lengths lens [rows] int32;
// buf [G] uint8; base, glen, g0, r0, row [n] int32; scratch of
// gaml_exact_scratch(n, rmax) int32 for the candidates' order; outputs ok
// uint8 [n], errs and begin int32 [n].
extern "C" int gaml_extend_exact(const void* codes, const void* lens,
                                 const void* buf, const void* base,
                                 const void* glen, const void* g0,
                                 const void* r0, const void* row,
                                 void* scratch, int n, int Lc, int rmax,
                                 void* ok_out, void* errs_out,
                                 void* begin_out, void* stream) {
  const ResidentLoad load{
      static_cast<const uint8_t*>(codes), static_cast<const int32_t*>(lens),
      static_cast<const uint8_t*>(buf), static_cast<const int32_t*>(base),
      static_cast<const int32_t*>(glen), static_cast<const int32_t*>(g0),
      static_cast<const int32_t*>(r0), static_cast<const int32_t*>(row), Lc};
  return launch_exact(load, n, rmax, scratch, ok_out, errs_out, begin_out,
                      stream);
}

// The same, staged loader: the staged dict's candidate-major views
// read_f/read_b [n, rmax] and gwin_f/gwin_b [n, rmax + 2*PAD] uint8,
// rlen_*, glen_*, g0, r0 [n] int32 and at_start [n] uint8 (bool).
extern "C" int gaml_extend_exact_staged(
    const void* read_f, const void* gwin_f, const void* rlen_f,
    const void* glen_f, const void* read_b, const void* gwin_b,
    const void* rlen_b, const void* glen_b, const void* g0, const void* r0,
    const void* at_start, void* scratch, int n, int rmax, void* ok_out,
    void* errs_out, void* begin_out, void* stream) {
  const StagedLoad load{
      static_cast<const uint8_t*>(read_f), static_cast<const uint8_t*>(gwin_f),
      static_cast<const int32_t*>(rlen_f), static_cast<const int32_t*>(glen_f),
      static_cast<const uint8_t*>(read_b), static_cast<const uint8_t*>(gwin_b),
      static_cast<const int32_t*>(rlen_b), static_cast<const int32_t*>(glen_b),
      static_cast<const int32_t*>(g0), static_cast<const int32_t*>(r0),
      static_cast<const uint8_t*>(at_start), rmax};
  return launch_exact(load, n, rmax, scratch, ok_out, errs_out, begin_out,
                      stream);
}

// The int32 scratch the exact entries need for n candidates at row bound
// rmax.
extern "C" int gaml_exact_scratch(int n, int rmax) {
  return order_scratch(n, rmax);
}
