// Banded forward DP for long reads on Hopper (sm_90a): kernel K5.
//
// Replaces the TPU kernel of gaml_tpu/ops/forward_pallas.py:
//   K5  banded_forward_pallas_call  (_fwd_kernel)
// and computes what gaml_tpu.ops.forward.banded_forward computes (its
// torch twin is gaml_tpu_torch.ops.forward.banded_forward): the total
// probability mass, in natural log, of all alignments of a read against a
// genome target inside a W-lane band that follows a guide path (reference
// AligmentProbability, graph.cc:2175-2297).  Lane o of row j covers genome
// position base_j + o, base_0 = c0 - W/2, base_j = base_{j-1} + step_j
// with steps clipped to 0..2.  In probabilities, PM = exp(log_match) and
// PMM = exp(log_mismatch), per row:
//   cw[o]   = seq[base + o - 1] (9 outside the buffer)
//   S[o]    = 0 if cw >= 8, else PM if cw == read[j-1], else PMM
//   b[o]    = p[o + step - 1] S[o] + p[o + step] PMM inside
//             [gstart, gstart + glen), else 0
//   x[o]    = b[o] + G[o] x[o - 1], G[o] = PMM inside the target where
//             cw < 8, else 0
// and the result is the log of the last row's sum (-1e30 where rlen <= 0
// or no mass is left), as the log-space forms compute it.
//
// Design.  Scaled linear space: each lane holds p = exp(m - E ln 2), a
// float64 probability with one integer exponent E per job, so a band cell
// costs a multiply and two FMAs and no transcendental (a log-space form
// pays an exp and a log1p per logaddexp, several per cell).
// After every kRenormRows-th row the warp takes the max exponent of its
// lanes with one __reduce_max_sync on the doubles' high words (they order
// like the values' exponents), and the next row is scaled by the power of
// two that brings that max into [1, 2), the power added to E: exact, and
// linear, so the reduction stays off the row's chain.  A row shrinks the
// max by about PMM^3 at worst and grows it by less than 2, so 32 rows keep
// it far inside float64's range.  Why float64: a band's lanes can lie
// hundreds of nats below its max and still carry the alignment later (a
// guide stuck at a walk's first column while the read's true path runs
// on, then catching up); float32 keeps only 103 nats (2^-149) below the
// max, and in float32 this arithmetic misses such walk scores and the
// adversarial batch's stuck guides by many nats (PERF.md).  Float64 keeps
// 744 nats at the cost of two shuffles a value; the build keeps denormals
// (no -use_fast_math), and tests/test_torch_forward.py holds the CPU twin
// of this arithmetic (ops/forward.py::banded_forward_scaled) against the
// exact float64 log-space forms on those cases.
//
// One warp per job, W/32 neighbouring band lanes a thread (2 at W = 64, 4
// at W = 128), the row loop inside the kernel (the TPU's sequential grid
// axis) and bounded by the job's own rlen.  The within-row gap chain is
// exact (the TPU kernel truncates it at 15 gaps): each thread composes
// the affine maps x -> b + G x of its lanes, a 5-level shuffle scan
// composes them across the warp, and each thread finishes its lanes from
// its left neighbour's x (one shuffle) with one FMA each.  The lanes a
// thread needs from its neighbours' previous row come by one shuffle (from
// the left at step 0, else from the right) and a second at step 2.  That
// chain of shuffles is the row's critical path, so the rest is kept off
// it:
// - steps and read characters arrive 32 rows at a time, one row per lane,
//   loaded two chunks ahead, and are broadcast two rows ahead;
// - each thread's genome bytes for the next row are loaded during the
//   current one;
// - a thread whose lanes all lie inside the target on genome bytes < 8
//   (nearly every thread of nearly every row) takes a short path with
//   G = PMM throughout; one whose lanes all lie outside it, b = G = 0.
// A composed map's factor is a power of PMM when all of its lanes are open
// (inside the target, cw < 8) and 0 otherwise, so it comes from one
// __ballot_sync a row (each thread's distance to the nearest closed
// thread at or left of it) and each scan level needs one shuffle.
//
// What bounds it on an H100: the serial row chain of the longest job (7
// shuffle steps and about a dozen dependent FP64 operations a row) and the issue
// rate of all rows of the batch, not memory (a row moves W bytes of genome
// that the L1 holds across the rows of a job, one step and one read byte).
// Jobs of a batch are not sorted by length; warps of short jobs leave
// early.  Renormalising every 32 rows and the ballot scan were each
// faster on the card than every 8 rows and a two-shuffle scan (PERF.md).

#include <cstdint>
#include <cuda_runtime.h>


namespace {

constexpr float kNeg = -1e30f;
constexpr int kWarps = 4;  // jobs per block
constexpr unsigned kFull = 0xffffffffu;
constexpr int kRenormRows = 32;  // rows between renormalisations
// what the genome loads read where the walk buffer is shorter than a
// thread's lanes
__device__ const uint8_t kNoGenome[4] = {9, 9, 9, 9};

// 2^k for k in -1022 .. 1023, exactly
__device__ __forceinline__ double power_of_two(int k) {
  return __longlong_as_double(static_cast<long long>(k + 1023) << 52);
}

template <int W>
__global__ void __launch_bounds__(32 * kWarps)
banded_forward_kernel(const uint8_t* __restrict__ reads, int n_rows,
                      int read_stride, const int32_t* __restrict__ row,
                      const uint8_t* __restrict__ seq, int seq_len,
                      const uint8_t* __restrict__ steps, int rmax,
                      const int32_t* __restrict__ c0,
                      const int32_t* __restrict__ gstart,
                      const int32_t* __restrict__ glen,
                      const int32_t* __restrict__ rlen, int n_jobs,
                      float log_match, float log_mismatch,
                      float* __restrict__ out) {
  static_assert(W == 64 || W == 128, "W must be 64 or 128");
  constexpr int L = W / 32;  // band lanes per thread
  const int lane = threadIdx.x & 31;
  const int job = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (job >= n_jobs) return;  // the whole warp leaves together
  const int r = row[job];
  if (r < 0 || r >= n_rows) {
    if (lane == 0) out[job] = __int_as_float(0x7fc00000);  // NaN
    return;
  }
  const uint8_t* read = reads + static_cast<size_t>(r) * read_stride;
  const uint8_t* st = steps + static_cast<size_t>(job) * rmax;
  const int rows = max(0, min(rlen[job], min(rmax, read_stride)));
  if (rows == 0) {
    if (lane == 0) out[job] = kNeg;
    return;
  }
  const int gs = gstart[job];
  const unsigned gl = static_cast<unsigned>(max(glen[job], 0));
  const int o0 = lane * L;
  int base = c0[job] - W / 2;  // genome position of band lane 0
  const double pm = exp(static_cast<double>(log_match));
  const double pmm = exp(static_cast<double>(log_mismatch));

  // PMM^(i + 1), the prefix products of a thread whose lanes are all
  // open; scan level k (distance d = 2^k): the factor of d threads whose
  // lanes are all open, PMM^(L d)
  double pmm_pow[L], coef[5];
  pmm_pow[0] = pmm;
#pragma unroll
  for (int i = 1; i < L; ++i) pmm_pow[i] = pmm_pow[i - 1] * pmm;
  coef[0] = pmm_pow[L - 1];
#pragma unroll
  for (int k = 1; k < 5; ++k) coef[k] = coef[k - 1] * coef[k - 1];
  // whether a thread's lanes can all lie inside the buffer and the target
  const bool window_ok = seq_len >= L;
  const bool target_ok = gl >= static_cast<unsigned>(L);

  double p[L];
#pragma unroll
  for (int i = 0; i < L; ++i)
    p[i] = static_cast<unsigned>(base + o0 + i - gs) < gl ? 1.0 : 0.0;
  int e_sum = 0;       // the job's binary exponent E
  unsigned ex = 1023;  // exponent field of the last renormalised row's max
  bool pending = false;  // a scale taken from a row, not applied yet

  // lane k of a chunk holds row (chunk + k)'s step | read char << 8.  A
  // chunk's bytes are loaded two chunks ahead and packed one chunk ahead,
  // so no load is consumed within 32 rows of its issue
  auto fetch_step = [&](int j) {
    int step = 0;
    if (j + lane < rows) step = st[j + lane];
    return step;
  };
  auto fetch_char = [&](int j) {
    int ch = 0;
    if (j + lane < rows) ch = read[j + lane];
    return ch;
  };
  auto pack = [](int step, int ch) { return min(step, 2) | (ch << 8); };
  // the genome bytes of this thread's lanes at band base b: L bytes from
  // the thread's first lane, the window clamped into the buffer as a whole.
  // They are right wherever the window lies inside the buffer, the only
  // case that uses them, and are consumed a row after their load
  const uint8_t* sq = window_ok ? seq : kNoGenome;
  const int win_last = max(seq_len - L, 0);
  auto load_raw = [&](int b, int* raw) {
    const uint8_t* w = sq + min(max(b + o0 - 1, 0), win_last);
#pragma unroll
    for (int i = 0; i < L; ++i) raw[i] = w[i];
  };

  int cur = pack(fetch_step(0), fetch_char(0));
  // chunk c + 1 as loaded
  int step_a = fetch_step(32), ch_a = fetch_char(32);
  int v = __shfl_sync(kFull, cur, 0);
  int delta = v & 3, rc = v >> 8;
  base += delta;
  int raw[L];
  load_raw(base, raw);
  v = __shfl_sync(kFull, cur, 1);  // row j + 1's while row j runs

  for (int j0 = 0; j0 < rows; j0 += 32) {
    const int nxt = pack(step_a, ch_a);
    const int step_b = fetch_step(j0 + 64), ch_b = fetch_char(j0 + 64);
    const int n = min(32, rows - j0);
#pragma unroll 2
    for (int k = 0; k < n; ++k) {
      const int j = j0 + k;
      // row j + 1's genome bytes and row j + 2's step and read char, a
      // row and two rows ahead of their use
      const int delta1 = v & 3, rc1 = v >> 8;
      const int base1 = base + delta1;
      int raw1[L];
      load_raw(base1, raw1);
      const int v2 = __shfl_sync(kFull, k + 2 < 32 ? cur : nxt, (k + 2) & 31);

      // q[m] = previous row at lane o0 - 1 + delta + m, m = 0 .. L: the
      // left neighbour's last lane at step 0, else the right one's first
      // (and second, at step 2)
      const bool d0 = delta == 0;
      double t1 = __shfl_sync(kFull, d0 ? p[L - 1] : p[0],
                              d0 ? (lane + 31) & 31 : (lane + 1) & 31);
      if (d0 ? lane == 0 : lane == 31) t1 = 0.0;
      double t2 = 0.0;
      if (delta == 2) {
        t2 = __shfl_down_sync(kFull, p[1], 1);
        if (lane == 31) t2 = 0.0;
      }
      double q[L + 1];
#pragma unroll
      for (int m = 0; m <= L; ++m) {
        const double a0 = m == 0 ? t1 : p[m > 0 ? m - 1 : 0];
        const double a1 = m == L ? t1 : p[m < L ? m : L - 1];
        const double a2 = m == L ? t2
                                : (m == L - 1 ? t1 : p[m + 1 < L ? m + 1 : 0]);
        q[m] = delta == 0 ? a0 : (delta == 1 ? a1 : a2);
      }

      // this thread's lanes: b, the local chain lx from x = 0 and the
      // prefix products pr of G, so x[o0 + i] = lx[i] + pr[i] x_entering.
      // All lanes inside the target on genome bytes < 8 of the buffer (G =
      // PMM everywhere), all outside it (b = G = 0), or each lane on its
      // own (target and buffer edges)
      const int t = base + o0 - gs;  // target offset of lane o0
      const int g0 = base + o0 - 1;  // genome index of lane o0
      int any_big = 0;
#pragma unroll
      for (int i = 0; i < L; ++i) any_big |= raw[i];
      const bool open =
          window_ok &&
          static_cast<unsigned>(g0) <= static_cast<unsigned>(win_last) &&
          target_ok && static_cast<unsigned>(t) <= gl - L && any_big < 8;
      const bool empty = t >= static_cast<int>(gl) || t + L <= 0;
      double lx[L], pr[L];
      if (open) {
#pragma unroll
        for (int i = 0; i < L; ++i) {
          const double b = fma(q[i], raw[i] == rc ? pm : pmm, q[i + 1] * pmm);
          lx[i] = i == 0 ? b : fma(pmm, lx[i - 1], b);
          pr[i] = pmm_pow[i];
        }
      } else if (empty) {
#pragma unroll
        for (int i = 0; i < L; ++i) lx[i] = pr[i] = 0.0;
      } else {
#pragma unroll
        for (int i = 0; i < L; ++i) {
          const bool in_t = static_cast<unsigned>(t + i) < gl;
          const int cw = static_cast<unsigned>(g0 + i) <
                                 static_cast<unsigned>(seq_len)
                             ? static_cast<int>(seq[g0 + i])
                             : 9;
          const bool ok = cw < 8;
          const double s = ok ? (cw == rc ? pm : pmm) : 0.0;
          const double b = in_t ? fma(q[i], s, q[i + 1] * pmm) : 0.0;
          const double g = in_t && ok ? pmm : 0.0;
          lx[i] = i == 0 ? b : fma(g, lx[i - 1], b);
          pr[i] = i == 0 ? g : pr[i - 1] * g;
        }
      }

      // inclusive scan of the threads' maps (factor, x at the last lane)
      // dist = lane - (the nearest closed lane <= lane), or lane if none:
      // the span of d threads ending here is all open iff dist >= d
      double cx = lx[L - 1];
      const bool all_open = open || pr[L - 1] != 0.0;
      const unsigned closed =
          ~__ballot_sync(kFull, all_open) & ((2u << lane) - 1u);
      const int dist = closed ? lane - (31 - __clz(closed)) : lane;
#pragma unroll
      for (int lv = 0; lv < 5; ++lv) {
        const double px = __shfl_up_sync(kFull, cx, 1 << lv);
        cx = fma(dist >= (1 << lv) ? coef[lv] : 0.0, px, cx);
      }
      // the renormalisation of the row before: the row is linear in the
      // previous one, so its scale applies here, off the scan's chain
      if (pending) {
        pending = false;
        const double sc = power_of_two(1023 - static_cast<int>(ex));
        e_sum += static_cast<int>(ex) - 1023;
#pragma unroll
        for (int i = 0; i < L; ++i) {
          lx[i] *= sc;
          pr[i] *= sc;
        }
      }
      double x = __shfl_up_sync(kFull, cx, 1);
      if (lane == 0) x = 0.0;
#pragma unroll
      for (int i = 0; i < L; ++i) p[i] = fma(pr[i], x, lx[i]);

      if ((j & (kRenormRows - 1)) == kRenormRows - 1) {
        // scale by 2^(1023 - ex), ex the max's exponent field (a zero or
        // denormal max has ex = 0 and is scaled by 2^1023), from the next
        // row; the high words of non-negative doubles order like their
        // exponents
        double mx = p[0];
#pragma unroll
        for (int i = 1; i < L; ++i) mx = fmax(mx, p[i]);
        ex = __reduce_max_sync(
                 kFull, static_cast<unsigned>(__double2hiint(mx))) >> 20;
        pending = true;
      }

      delta = delta1;
      rc = rc1;
      base = base1;
      v = v2;
#pragma unroll
      for (int i = 0; i < L; ++i) raw[i] = raw1[i];
    }
    cur = nxt;
    step_a = step_b;
    ch_a = ch_b;
  }
  if (pending) {
    const double sc = power_of_two(1023 - static_cast<int>(ex));
    e_sum += static_cast<int>(ex) - 1023;
#pragma unroll
    for (int i = 0; i < L; ++i) p[i] *= sc;
  }

  double sum = 0.0;
#pragma unroll
  for (int i = 0; i < L; ++i) sum += p[i];
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) sum += __shfl_xor_sync(kFull, sum, d);
  if (lane == 0) {
    // sum = s1 2^(ef - 1023), ef its exponent field, s1 in [1, 2) (below
    // 1 for a denormal sum): one float log, the rest exact
    const int ef = (__double2hiint(sum) >> 20) & 0x7ff;
    const float s1 = static_cast<float>(sum * power_of_two(1023 - ef));
    out[job] = sum > 0.0
                   ? static_cast<float>(logf(s1) + (e_sum + ef - 1023) *
                                                       0.6931471805599453)
                   : kNeg;
  }
}

template <int W>
void launch(const void* reads, int n_rows, int read_stride, const void* row,
            const void* seq, int seq_len, const void* steps, int rmax,
            const void* c0, const void* gstart, const void* glen,
            const void* rlen, int n_jobs, float log_match,
            float log_mismatch, void* out, cudaStream_t stream) {
  const int blocks = (n_jobs + kWarps - 1) / kWarps;
  banded_forward_kernel<W><<<blocks, 32 * kWarps, 0, stream>>>(
      static_cast<const uint8_t*>(reads), n_rows, read_stride,
      static_cast<const int32_t*>(row), static_cast<const uint8_t*>(seq),
      seq_len, static_cast<const uint8_t*>(steps), rmax,
      static_cast<const int32_t*>(c0), static_cast<const int32_t*>(gstart),
      static_cast<const int32_t*>(glen), static_cast<const int32_t*>(rlen),
      n_jobs, log_match, log_mismatch, static_cast<float*>(out));
}

}  // namespace

// K5: one log-probability per job.  reads [n_rows, read_stride] uint8
// read codes; row [n_jobs] int32 (the job's row of reads); seq [seq_len]
// uint8 walk buffer; steps [n_jobs, rmax] uint8 guide steps; c0, gstart,
// glen, rlen [n_jobs] int32; out [n_jobs] f32.  All pointers are device
// pointers; the launch goes on ``stream`` and does not synchronise.
// Returns cudaErrorInvalidValue for a width other than 64 or 128, else
// cudaGetLastError() after the launch.
extern "C" int gaml_banded_forward(const void* reads, int n_rows,
                                   int read_stride, const void* row,
                                   const void* seq, int seq_len,
                                   const void* steps, int rmax,
                                   const void* c0, const void* gstart,
                                   const void* glen, const void* rlen,
                                   int n_jobs, int width, float log_match,
                                   float log_mismatch, void* out,
                                   void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (width == 64) {
    launch<64>(reads, n_rows, read_stride, row, seq, seq_len, steps, rmax,
               c0, gstart, glen, rlen, n_jobs, log_match, log_mismatch, out,
               s);
  } else if (width == 128) {
    launch<128>(reads, n_rows, read_stride, row, seq, seq_len, steps, rmax,
                c0, gstart, glen, rlen, n_jobs, log_match, log_mismatch, out,
                s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}


// The guide steps of K5's batch from its jobs' guide centers, staged
// raggedly: kernel forward_stage.  Replaces no TPU kernel: the JAX package
// staged a batch on the host (a padded [B, rmax + 1] centers matrix and
// its diff), which on a long-read batch (thousands of jobs, 11 M centers,
// rmax 15 k) costs seconds of host time for bytes the card moves in
// microseconds.  Here the centers arrive as one flat int32 buffer, job j's
// at centers[offsets[j] .. offsets[j + 1]), each in the frame of its own
// target, and the kernel writes what K5 reads:
//   steps[j, r] = clamp(c[r + 1] - c[r], 0, 2) for r < min(n_j - 1, rmax),
//                 else 0 (n_j the job's centers)
//   c0[j]       = c[0] + gstart[j] (the job's first column in the walk
//                 buffer; gstart[j] alone for a job without centers)
// which is what the padded matrix's int64 diff and first column give.
// Bound by bytes: the centers read once, steps and c0 written once.  A
// thread writes four steps as one 32-bit word (rmax a multiple of 4) from
// five neighbouring centers, a block 1024 columns of one job; columns
// past a job's centers are zeros and read nothing.

namespace {

constexpr int kStageThreads = 256;
constexpr int kStageCols = 4 * kStageThreads;  // columns a block
constexpr int kMaxGridY = 65535;

__global__ void __launch_bounds__(kStageThreads)
forward_stage_kernel(const int32_t* __restrict__ centers,
                     const int64_t* __restrict__ offsets,
                     const int32_t* __restrict__ gstart, int n_jobs,
                     int rmax, uint8_t* __restrict__ steps,
                     int32_t* __restrict__ c0) {
  const int r0 = (blockIdx.x * kStageThreads + threadIdx.x) * 4;
  for (int job = blockIdx.y; job < n_jobs; job += gridDim.y) {
    const long long off = offsets[job];
    const long long n = offsets[job + 1] - off;
    if (blockIdx.x == 0 && threadIdx.x == 0)
      c0[job] = (n > 0 ? centers[off] : 0) + gstart[job];
    if (r0 >= rmax) continue;
    // the steps that come from centers: r < last
    const int last = static_cast<int>(
        min(max(n - 1, 0LL), static_cast<long long>(rmax)));
    uint32_t word = 0;
    if (r0 < last) {
      const int32_t* c = centers + off + r0;
      int prev = c[0];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (r0 + k < last) {
          const int next = c[k + 1];
          const long long d = static_cast<long long>(next) - prev;
          word |= static_cast<uint32_t>(min(max(d, 0LL), 2LL)) << (8 * k);
          prev = next;
        }
      }
    }
    reinterpret_cast<uint32_t*>(steps + static_cast<size_t>(job) * rmax)
        [r0 / 4] = word;
  }
}

}  // namespace

// forward_stage: centers [offsets[n_jobs]] int32, offsets [n_jobs + 1]
// int64, gstart [n_jobs] int32; writes steps [n_jobs, rmax] uint8 and c0
// [n_jobs] int32.  All pointers are device pointers; steps 4-byte
// aligned.  The launch goes on ``stream`` and does not synchronise.
// Returns cudaErrorInvalidValue unless rmax >= 0 is a multiple of 4 and
// n_jobs > 0, else cudaGetLastError() after the launch.
extern "C" int gaml_forward_stage(const void* centers, const void* offsets,
                                  const void* gstart, int n_jobs, int rmax,
                                  void* steps, void* c0, void* stream) {
  if (n_jobs <= 0 || rmax < 0 || rmax % 4 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int col_blocks = (rmax + kStageCols - 1) / kStageCols;
  const dim3 grid(col_blocks > 0 ? col_blocks : 1,
                  n_jobs < kMaxGridY ? n_jobs : kMaxGridY);
  forward_stage_kernel<<<grid, kStageThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(centers),
      static_cast<const int64_t*>(offsets),
      static_cast<const int32_t*>(gstart), n_jobs, rmax,
      static_cast<uint8_t*>(steps), static_cast<int32_t*>(c0));
  return static_cast<int>(cudaGetLastError());
}
