// The short-read rescore's stages after the extension on Hopper (sm_90a):
// the first-wins dedup of the extension's alignments, their float64 sums
// per (job, read) and the floored mean-log reduction (GetTotalProb), in
// two launches and one read-back.
//
// Replaces no Pallas kernel: the JAX package computes this as an XLA graph
// (gaml_tpu/ops/rescore_device.py, gaml_tpu/ops/score.py), and the port's
// first form was a chain of about 55 small torch kernels with three host
// synchronisations (ops/rescore_device.py::score_plain, the plain
// version): a stable sort of every candidate on an int64 (group, begin)
// key, index_add_ into the bins, the reduction by job in a Python loop.
// What it computes (graph.cc:895-897, 1482-1537): the candidates arrive
// from candgen in runs of equal (segment, read) (its stable sort); a
// candidate is kept when the extension found it (ok) and no earlier
// candidate of its run with ok has the same begin; each kept alignment
// adds mm^errs * m^(len - errs) to the bin (job of its segment) * n_reads
// + read; each bin's log less log(2 total_len) of its job is floored at
// min_prob_start + min_prob_per_base * len, and a job's score is the mean
// over its reads.
//
// Design:
// - rescore_dedup_sums_kernel: a block per tile of kTile candidates owns
//   the runs that start in its tile (head flags, one block scan, the
//   heads' positions in shared memory); a run that goes on past the
//   tile's end is the block's too, its end found by a block-wide search
//   forward.  A run of one candidate keeps it if ok.  Every longer run
//   [s, s + R) is deduplicated in an open-addressing table of its own, the
//   2R slots [2s, 2s + 2R) of a workspace of 2n: its ok candidates claim
//   their begin's slot (atomicCAS) and leave the least candidate index
//   there (atomicMin); after a barrier each is kept if its index is the
//   least; after another the block clears the run's slots for the next
//   call.  Linear in the candidates however long a run is (a repeat
//   inside a window gives runs of thousands), and no sort.  A kept
//   alignment's probability is a float64 atomicAdd into its bin (native on
//   sm_90; in no fixed order, as index_add_'s on the card), the kept count
//   one integer atomicAdd a block.
// - rescore_reduce_kernel: a block per kRTile bins of a job reads each bin
//   once and zeroes it behind (the next call's sums start from zero with
//   no memset), and sums the floored logs in float64 in a fixed tree (a
//   thread's kRPer bins in order, a warp butterfly, the warps' sums); the
//   last block to finish sums each job's partials in the same tree and
//   writes the scores, zero reads and kept count into one small buffer,
//   copied to pinned host memory.  No float atomics: the same sums give
//   the same score.
//
// What bounds it on an H100: neither bytes (about 37 a candidate and 12 a
// bin: some 12 MB, 4 us at 3.35 TB/s, for the rescore's 0.25 M candidates
// and 150k reads) nor operations (an exp a kept alignment, a log a bin).
// Latency does: two launches, a chain of dependent global atomics in each
// table, the reduction's last block, and the read-back.

#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;  // of the dedup pass: a candidate a thread
constexpr int kTile = kThreads;
constexpr int kWarps = kThreads / 32;
constexpr int kRThreads = 256;  // of the reduction
constexpr int kRWarps = kRThreads / 32;
constexpr int kRPer = 8;  // bins a thread, in order
constexpr int kRTile = kRThreads * kRPer;
constexpr unsigned long long kEmpty = ~0ull;  // a free table slot
constexpr int kNoIdx = 0x7fffffff;            // a slot's index, unclaimed
constexpr long long kPast = 0x7fffffffffffffffll;  // a run end past the tile
// ctl (uint64): [0] alignments kept, [1] finished blocks of the reduction

__device__ __forceinline__ bool is_head(const long long* seg,
                                        const long long* rid, long long i) {
  return i == 0 || seg[i] != seg[i - 1] || rid[i] != rid[i - 1];
}

// Exclusive sum of v over the block (kThreads) and the block's total.
__device__ __forceinline__ int block_excl_sum(int v, int* s_warp,
                                              int& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(~0u, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) s_warp[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int w = lane < kWarps ? s_warp[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(~0u, w, o);
      if (lane >= o) w += y;
    }
    if (lane < kWarps) s_warp[lane] = w;
  }
  __syncthreads();
  total = s_warp[kWarps - 1];
  return x - v + (warp ? s_warp[warp - 1] : 0);
}

// The slot of ``begin`` in the table [base, base + m): claimed if free
// (``insert``), else found where an insert left it.
__device__ __forceinline__ long long table_slot(unsigned long long* tkey,
                                                long long base, uint32_t m,
                                                int begin, bool insert) {
  const unsigned long long key = static_cast<uint32_t>(begin);
  uint32_t h = static_cast<uint32_t>(
      (static_cast<uint64_t>(static_cast<uint32_t>(begin) * 0x9E3779B1u) *
       m) >> 32);
  for (;;) {
    unsigned long long* p = tkey + base + h;
    const unsigned long long cur =
        insert ? atomicCAS(p, kEmpty, key) : __ldcg(p);
    if (cur == key || (insert && cur == kEmpty)) return base + h;
    h = h + 1 == m ? 0 : h + 1;
  }
}

__global__ void __launch_bounds__(kThreads) rescore_dedup_sums_kernel(
    const uint8_t* __restrict__ ok, const int* __restrict__ errs,
    const int* __restrict__ begin, const long long* __restrict__ seg,
    const long long* __restrict__ rid, const int* __restrict__ lens,
    const int* __restrict__ seg_job, long long n, long long n_reads,
    double log_match, double log_mismatch, unsigned long long* tkey,
    int* tidx, double* bins, unsigned long long* ctl) {
  __shared__ long long s_pos[kTile + 1];
  __shared__ int s_warp[kWarps];
  __shared__ unsigned long long s_end;
  __shared__ int s_kept;
  const long long t0 = static_cast<long long>(blockIdx.x) * kTile;
  const long long tile_end = t0 + kTile < n ? t0 + kTile : n;
  const long long i = t0 + threadIdx.x;
  const bool head = i < n && is_head(seg, rid, i);
  int heads;
  const int rank = block_excl_sum(head, s_warp, heads);
  if (heads == 0) return;  // the tile lies inside a run an earlier block owns
  if (head) s_pos[rank] = i;
  if (threadIdx.x == 0) {
    s_pos[heads] =
        tile_end == n || is_head(seg, rid, tile_end) ? tile_end : kPast;
    s_end = static_cast<unsigned long long>(n);
    s_kept = 0;
  }
  __syncthreads();
  // the tile's last run, and its end when it goes on past the tile
  const long long last_s = s_pos[heads - 1];
  const bool spill = s_pos[heads] == kPast;
  if (spill) {
    for (long long q0 = tile_end; q0 < n; q0 += kThreads) {
      const long long q = q0 + threadIdx.x;
      if (q < n && is_head(seg, rid, q))
        atomicMin(&s_end, static_cast<unsigned long long>(q));
      __syncthreads();
      const unsigned long long e = s_end;
      __syncthreads();
      if (e < static_cast<unsigned long long>(n)) break;
    }
  }
  const long long last_e =
      spill ? static_cast<long long>(s_end) : s_pos[heads];
  // this thread's candidate: its run [s, s + len), if the block owns it
  const int r = rank + head - 1;
  const bool own = i < n && r >= 0;
  long long s = 0, len = 0;
  if (own) {
    s = s_pos[r];
    len = (r == heads - 1 ? last_e : s_pos[r + 1]) - s;
  }
  const long long tail_n = spill ? last_e - tile_end : 0;
  const long long tail_len = last_e - last_s;
  // 1. the ok candidates of runs longer than one claim their begins
  if (own && len > 1 && ok[i])
    atomicMin(tidx + table_slot(tkey, 2 * s, 2 * len, begin[i], true),
              static_cast<int>(i));
  for (long long k = threadIdx.x; k < tail_n; k += kThreads) {
    const long long q = tile_end + k;
    if (ok[q])
      atomicMin(tidx + table_slot(tkey, 2 * last_s, 2 * tail_len, begin[q],
                                  true),
                static_cast<int>(q));
  }
  __syncthreads();
  // 2. the kept alignments into their bins
  auto add = [&](long long q) {
    const long long rd = rid[q];
    const double e = static_cast<double>(errs[q]);
    const double lp = __dadd_rn(
        __dmul_rn(e, log_mismatch),
        __dmul_rn(__dsub_rn(static_cast<double>(lens[rd]), e), log_match));
    const long long job = seg_job ? seg_job[seg[q]] : 0;
    atomicAdd(bins + job * n_reads + rd, exp(lp));
    atomicAdd(&s_kept, 1);
  };
  if (own && ok[i]) {
    if (len == 1 ||
        __ldcg(tidx + table_slot(tkey, 2 * s, 2 * len, begin[i], false)) == i)
      add(i);
  }
  for (long long k = threadIdx.x; k < tail_n; k += kThreads) {
    const long long q = tile_end + k;
    if (ok[q] && __ldcg(tidx + table_slot(tkey, 2 * last_s, 2 * tail_len,
                                          begin[q], false)) == q)
      add(q);
  }
  __syncthreads();
  // 3. the tables cleared for the next call: candidate q clears slots 2q
  // and 2q + 1, so a run's candidates clear its table
  if (own && len > 1) {
    const long long at = 2 * i;
    tkey[at] = tkey[at + 1] = kEmpty;
    tidx[at] = tidx[at + 1] = kNoIdx;
  }
  for (long long k = threadIdx.x; k < tail_n; k += kThreads) {
    const long long at = 2 * (tile_end + k);
    tkey[at] = tkey[at + 1] = kEmpty;
    tidx[at] = tidx[at + 1] = kNoIdx;
  }
  __syncthreads();
  if (threadIdx.x == 0 && s_kept)
    atomicAdd(ctl, static_cast<unsigned long long>(s_kept));
}

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(~0u, v, o);
  return v;
}

__device__ __forceinline__ long long warp_sum(long long v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(~0u, v, o);
  return v;
}

// The block's sum in its fixed tree (each warp's butterfly, then warp 0's
// over the warps' sums); valid in warp 0.
template <typename T>
__device__ __forceinline__ T block_sum(T v, T* s_w) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = warp_sum(v);
  if (lane == 0) s_w[warp] = v;
  __syncthreads();
  T t = 0;
  if (warp == 0) t = warp_sum(lane < kRWarps ? s_w[lane] : T(0));
  __syncthreads();
  return t;
}

__global__ void __launch_bounds__(kRThreads) rescore_reduce_kernel(
    double* __restrict__ bins, const int* __restrict__ lens,
    long long n_reads, int n_jobs, int per_job,
    const double* __restrict__ log_tot, double log_tot0, double floor_start,
    double floor_per_base, double* part_sum, long long* part_zero,
    unsigned long long* ctl, long long* __restrict__ out) {
  __shared__ double s_d[kRWarps];
  __shared__ long long s_z[kRWarps];
  __shared__ bool s_last;
  const int job = blockIdx.x / per_job, b = blockIdx.x % per_job;
  const double lt = log_tot ? log_tot[job] : log_tot0;
  double sum = 0.0;
  long long zeros = 0;
#pragma unroll
  for (int k = 0; k < kRPer; ++k) {
    const long long j =
        static_cast<long long>(b) * kRTile + k * kRThreads + threadIdx.x;
    if (j < n_reads) {
      double* at = bins + job * n_reads + j;
      const double p = *at;
      *at = 0.0;
      const double lp = p > 0.0 ? __dsub_rn(log(p), lt) : -INFINITY;
      const double fl =
          __dadd_rn(floor_start,
                    __dmul_rn(floor_per_base, static_cast<double>(lens[j])));
      const bool floored = lp < fl;
      zeros += floored;
      sum += floored ? fl : lp;
    }
  }
  sum = block_sum(sum, s_d);
  zeros = block_sum(zeros, s_z);
  if (threadIdx.x == 0) {
    part_sum[blockIdx.x] = sum;
    part_zero[blockIdx.x] = zeros;
    __threadfence();
    s_last = atomicAdd(ctl + 1, 1ull) == gridDim.x - 1;
  }
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  for (int jb = 0; jb < n_jobs; ++jb) {
    double v = 0.0;
    long long z = 0;
    for (int k = threadIdx.x; k < per_job; k += kRThreads) {
      v += __ldcg(part_sum + jb * per_job + k);
      z += __ldcg(part_zero + jb * per_job + k);
    }
    v = block_sum(v, s_d);
    z = block_sum(z, s_z);
    if (threadIdx.x == 0) {
      out[jb] = __double_as_longlong(
          v / static_cast<double>(n_reads > 1 ? n_reads : 1));
      out[n_jobs + jb] = z;
    }
  }
  if (threadIdx.x == 0) {
    out[2 * n_jobs] = static_cast<long long>(__ldcg(ctl));
    ctl[0] = 0;
    ctl[1] = 0;
  }
}

}  // namespace

// Constants the wrapper checks: candidates a tile of the dedup pass, bins a
// block of the reduction and a thread's share of them.
extern "C" int gaml_rescore_tile() { return kTile; }
extern "C" int gaml_rescore_reduce_tile() { return kRTile; }
extern "C" int gaml_rescore_reduce_threads() { return kRThreads; }

// After the extension, n >= 1 candidates: ok uint8, errs and begin int32
// [n]; seg, rid int64 [n], in runs of equal (seg, rid); lens int32
// [n_reads]; seg_job int32 [segments] (null: one job); tkey uint64 and
// tidx int32 [2n], all kEmpty and kNoIdx (left so); bins float64 [jobs *
// n_reads], the sums added in; ctl uint64 [2].
extern "C" int gaml_rescore_dedup_sums(
    const void* ok, const void* errs, const void* begin, const void* seg,
    const void* rid, const void* lens, const void* seg_job, long long n,
    long long n_reads, double log_match, double log_mismatch, void* tkey,
    void* tidx, void* bins, void* ctl, void* stream) {
  if (n < 1 || n >= kNoIdx) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long blocks = (n + kTile - 1) / kTile;
  rescore_dedup_sums_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                              st>>>(
      static_cast<const uint8_t*>(ok), static_cast<const int*>(errs),
      static_cast<const int*>(begin), static_cast<const long long*>(seg),
      static_cast<const long long*>(rid), static_cast<const int*>(lens),
      static_cast<const int*>(seg_job), n, n_reads, log_match, log_mismatch,
      static_cast<unsigned long long*>(tkey), static_cast<int*>(tidx),
      static_cast<double*>(bins), static_cast<unsigned long long*>(ctl));
  return static_cast<int>(cudaGetLastError());
}

// The reduction of bins float64 [n_jobs * n_reads] (zeroed behind it):
// log_tot float64 [n_jobs] each job's log(2 total_len) (null: log_tot0 for
// the one job); part int64 [2 * n_jobs * per_job], per_job = ceil(n_reads /
// kRTile) (at least 1); out int64 [2 n_jobs + 1]: the scores' float64 bits,
// the zero reads, the kept count, copied to host_out (pinned) after the
// launch.  ctl is zeroed for the next call.  The caller waits for the
// stream before reading host_out.
extern "C" int gaml_rescore_reduce(void* bins, const void* lens,
                                   long long n_reads, int n_jobs,
                                   const void* log_tot, double log_tot0,
                                   double floor_start, double floor_per_base,
                                   void* part, void* ctl, void* out,
                                   void* host_out, void* stream) {
  if (n_reads < 0 || n_jobs < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long per = n_reads ? (n_reads + kRTile - 1) / kRTile : 1;
  const long long grid = per * n_jobs;
  if (grid >= (1ll << 31)) return static_cast<int>(cudaErrorInvalidValue);
  double* part_sum = static_cast<double*>(part);
  long long* part_zero = static_cast<long long*>(part) + grid;
  rescore_reduce_kernel<<<static_cast<unsigned>(grid), kRThreads, 0, st>>>(
      static_cast<double*>(bins), static_cast<const int*>(lens), n_reads,
      n_jobs, static_cast<int>(per), static_cast<const double*>(log_tot),
      log_tot0, floor_start, floor_per_base, part_sum, part_zero,
      static_cast<unsigned long long*>(ctl), static_cast<long long*>(out));
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaMemcpyAsync(
      host_out, out, sizeof(long long) * (2 * static_cast<size_t>(n_jobs) + 1),
      cudaMemcpyDeviceToHost, st));
}
