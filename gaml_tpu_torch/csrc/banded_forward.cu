// Banded log-space forward DP for long reads on Hopper (sm_90a): kernel K5.
//
// Replaces the TPU kernel of gaml_tpu/ops/forward_pallas.py:
//   K5  banded_forward_pallas_call  (_fwd_kernel)
// and computes what gaml_tpu.ops.forward.banded_forward computes (its
// torch twin is gaml_tpu_torch.ops.forward.banded_forward): the total
// probability mass, in natural log, of all alignments of a read against a
// genome target inside a W-lane band that follows a guide path (reference
// AligmentProbability, graph.cc:2175-2297).  Lane o of row j covers genome
// position base_j + o, base_0 = c0 - W/2, base_j = base_{j-1} + step_j
// with steps clipped to 0..2.  Per row:
//   cw[o]   = seq[base + o - 1] (9 outside the buffer)
//   s[o]    = -inf if cw >= 8, else log_match if cw == read[j-1], else
//             log_mismatch
//   b[o]    = logaddexp(m[o + step - 1] + s[o], m[o + step] + log_mismatch)
//             inside [gstart, gstart + glen), else -inf
//   x[o]    = logaddexp(b[o], x[o - 1] + gap[o]), gap[o] = log_mismatch
//             inside the target where cw < 8, else -inf
// and the result is the logsumexp of the last row (-inf where rlen <= 0);
// -inf is -1e30 throughout, as in the JAX kernels.
//
// Design.  One warp per job, W/32 neighbouring lanes per thread (2 at
// W = 64, 4 at W = 128), and the row loop inside the kernel (the TPU's
// sequential grid axis).  The previous row lives in registers; the lanes
// a thread needs from its neighbours (o + step - 1 .. o + step) come by
// one shuffle up and two down.  Each lane reads its genome char straight
// from the uint8 walk buffer at base + o - 1, so one row's loads are W
// neighbouring bytes; base is a register.  Steps and read chars arrive 32
// rows at a time, one per lane, and are broadcast by shuffles.  So none
// of the TPU's prestaged fetch/lo/hi/cw0/m0 arrays exist.  The within-row
// gap chain x is exact: each thread composes the affine maps
// x -> logaddexp(b, x + gap) of its lanes, a 5-step shuffle scan composes
// them across the warp, and each thread then replays its lanes from its
// left neighbour's x (the TPU kernel truncates the chain at 15 gaps with
// doubling shifts 1/2/4/8).  The loop runs to the job's own rlen, not to
// rmax, so no row is frozen.  The read rows come from a matrix indexed by
// a per-job row number: the resident forward and reverse-complement rows
// of a read set, or a per-batch dense matrix.
//
// What bounds it on an H100: the exp/log1p rate, not memory.  A cell
// costs about 3 + 5 / (W/32) logaddexps (one for b, two for the chain
// replay, the shuffle scan shared by the thread's lanes), each an exp and
// a log1p; a row moves W bytes of genome that the L1 holds across the
// rows of a job.  The design keeps all state in registers and reads no
// intermediate from memory; it trades the scan's shuffles for an exact
// chain.  Warps of ragged jobs idle once their job ends: sorting jobs by
// length, staging the walk window with cp.async, and cheaper logaddexp
// forms are later work.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr float kNeg = -1e30f;
constexpr int kWarps = 4;  // jobs per block
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float logaddexp(float a, float b) {
  const float hi = fmaxf(a, b);
  const float lo = fminf(a, b);
  return hi + log1pf(__expf(lo - hi));
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
  static_assert(W % 32 == 0 && W >= 64, "W must be a multiple of 32, >= 64");
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
  const int gs = gstart[job];
  const int ge = gs + glen[job];
  const int o0 = lane * L;
  int base = c0[job] - W / 2;  // genome position of band lane 0

  float m[L];
#pragma unroll
  for (int i = 0; i < L; ++i) {
    const int g = base + o0 + i;
    m[i] = (g >= gs && g < ge) ? 0.f : kNeg;
  }

  for (int j0 = 0; j0 < rows; j0 += 32) {
    // rows j0+1 .. j0+32: lane k holds row j0+1+k's step and read char
    int my_step = 0, my_char = 0;
    if (j0 + lane < rows) {
      my_step = min(static_cast<int>(st[j0 + lane]), 2);
      my_char = read[j0 + lane];
    }
    const int n = min(32, rows - j0);
    for (int k = 0; k < n; ++k) {
      const int delta = __shfl_sync(kFull, my_step, k);
      const int rc = __shfl_sync(kFull, my_char, k);
      base += delta;
      // e[i + 1] = previous row at lane o0 + i, i in -1 .. L + 1
      float e[L + 3];
      const float left = __shfl_up_sync(kFull, m[L - 1], 1);
      const float right0 = __shfl_down_sync(kFull, m[0], 1);
      const float right1 = __shfl_down_sync(kFull, m[1], 1);
      e[0] = lane == 0 ? kNeg : left;
#pragma unroll
      for (int i = 0; i < L; ++i) e[i + 1] = m[i];
      e[L + 1] = lane == 31 ? kNeg : right0;
      e[L + 2] = lane == 31 ? kNeg : right1;

      float bv[L], gap[L];
      float ca = 0.f, cx = kNeg;  // this thread's composed (gap, x) map
#pragma unroll
      for (int i = 0; i < L; ++i) {
        const float up = delta == 0 ? e[i + 1] : (delta == 1 ? e[i + 2]
                                                             : e[i + 3]);
        const float dg = delta == 0 ? e[i] : (delta == 1 ? e[i + 1]
                                                         : e[i + 2]);
        const int g = base + o0 + i;
        const int gi = g - 1;
        const int cw = (gi >= 0 && gi < seq_len) ? seq[gi] : 9;
        const bool in_t = g >= gs && g < ge;
        const float s = cw >= 8 ? kNeg : (cw == rc ? log_match : log_mismatch);
        bv[i] = in_t ? logaddexp(dg + s, up + log_mismatch) : kNeg;
        gap[i] = (in_t && cw < 8) ? log_mismatch : kNeg;
        cx = i == 0 ? bv[0] : logaddexp(bv[i], cx + gap[i]);
        ca += gap[i];
      }
      // inclusive scan of the threads' maps, then x entering this thread
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const float pa = __shfl_up_sync(kFull, ca, d);
        const float px = __shfl_up_sync(kFull, cx, d);
        if (lane >= d) {
          cx = logaddexp(cx, px + ca);
          ca += pa;
        }
      }
      float x = __shfl_up_sync(kFull, cx, 1);
      if (lane == 0) x = kNeg;
#pragma unroll
      for (int i = 0; i < L; ++i) {
        x = logaddexp(bv[i], x + gap[i]);
        m[i] = x;
      }
    }
  }

  // logsumexp of the last row
  float mx = m[0];
#pragma unroll
  for (int i = 1; i < L; ++i) mx = fmaxf(mx, m[i]);
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, d));
  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < L; ++i) sum += __expf(m[i] - mx);
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) sum += __shfl_xor_sync(kFull, sum, d);
  if (lane == 0) out[job] = rows > 0 ? mx + logf(sum) : kNeg;
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
