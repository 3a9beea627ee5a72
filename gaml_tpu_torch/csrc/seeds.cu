// The long-read seed lookup on Hopper (sm_90a): the walks' 13-mer index and
// every read's exact seed hits against it, for all ranges of one
// precompute at once, read from the resident read rows.
//
// Replaces no Pallas kernel: the JAX package computes this in numpy on the
// host (gaml_tpu/align/longread.py::SortedKmerIndex.hits_batch_kmers, one
// stable argsort and two unsorted searchsorted passes a range), and so did
// the port until this kernel.  What it computes, for each range r (a
// spelled sub-walk) and each query segment (range, read row) with the
// read's packed 13-mers at qpos = 0 .. len - 13 (codes >= 4 pack as 0, as
// index/maxhash.py::pack_kmers does): the range's k-mers sorted stably by
// value (positions ascending within a value), and for every query k-mer
// the first min(occurrences, MAX_KMER_OCC = 64) of its value's positions,
// as hits (tpos, qpos), in qpos order and within a qpos in position order:
// SortedKmerIndex.hits_kmers's hits and order, segment by segment.
//
// Design:
// - the index: seeds_keys_kernel packs every k-mer that lies wholly in its
//   range into the key (range << 26 | 13-mer) with its range-local
//   position as value, in (range, position) order, and counts the first
//   digit of each tile; a stable LSD radix sort of 8-bit digits
//   (seeds_hist_kernel, seeds_scatter_kernel; ranks within a tile by warp
//   rounds and __match_any_sync, as csrc/candgen.cu's multi-block sort)
//   orders them by (range, 13-mer, position); its last pass writes the
//   13-mers (uint32) and positions (int32).  Range r's k-mers are then
//   the slice [kstart[r], kstart[r + 1]), which the host knows from the
//   ranges' lengths.  No torch sort.
// - seeds_count_kernel: a thread takes kQPer consecutive query k-mers
//   (rolling its 13-mer along the segment's row of the resident read
//   matrix: one byte a k-mer after the first), finds each one's lower
//   bound in its range's slice by binary search and counts the equal
//   values after it up to 64 (most find none: one probe); it keeps the
//   bound and the count, and the block writes its tile's sum.
//   seeds_scan_kernel (one block) scans the tiles' sums into their offsets
//   and the total, which is copied to pinned host memory: the host's one
//   wait before the output is sized.
// - seeds_expand_kernel: each tile re-scans its counts, writes every hit
//   (tpos, qpos) as an int32 pair at its offset, and each segment's first
//   k-mer writes the segment's offset; the host copies offsets and hits
//   back in one copy.
//
// What bounds it on an H100: at a long-read rescore's shapes (about 1 M
// walk k-mers, 9-22 M query k-mers, 0.3 M hits) the bytes the design moves
// are the resident rows (a byte a query k-mer), the index written and read
// a few times (12 bytes a key, read twice and written once a sort pass),
// the query's bound and count (5 bytes a k-mer, written and read) and the
// hits (8 bytes each): some 270 MB at 11.5 M query k-mers, 80 us at 3.35
// TB/s.  Neither bytes nor operations set its time: the searches'
// dependent probes into the 8 MB index (L2 resident), the sort's short
// latency-bound passes and the host's wait between the count and the
// expansion do (PERF.md §6); the design keeps them to one binary search a
// query k-mer, one launch a pass and one wait.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kK = 13;                            // SEED_K
constexpr uint32_t kKMask = (1u << (2 * kK)) - 1;
constexpr int kMaxOcc = 64;                       // MAX_KMER_OCC

constexpr int kDigitBits = 8;
constexpr int kDigits = 1 << kDigitBits;
constexpr int kMaxPasses = 8;  // keys of up to 64 bits
constexpr int kSortThreads = 512;
constexpr int kSortIpt = 8;
constexpr int kSortTile = kSortThreads * kSortIpt;
constexpr int kSortWarps = kSortThreads / 32;
constexpr int kWarpItems = kSortTile / kSortWarps;
constexpr int kRounds = kWarpItems / 32;

constexpr int kQThreads = 256;  // of the count and expansion passes
constexpr int kQPer = 8;        // consecutive query k-mers a thread
constexpr int kQTile = kQThreads * kQPer;
constexpr int kScanThreads = 1024;

__device__ __forceinline__ uint32_t code2(uint8_t c) {
  return c < 4 ? c : 0u;
}

// Largest i in [0, n - 1] with start[i] <= p (start[0] <= p).
__device__ __forceinline__ int owner(const int64_t* start, int n,
                                     long long p) {
  int lo = 0, hi = n - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (start[mid] <= p) lo = mid; else hi = mid - 1;
  }
  return lo;
}

// Exclusive block scan (sum) of one value a thread; ``total`` gets the
// block's sum.  ``warp_tot``: NT / 32 values of shared memory.
template <typename T, int NT>
__device__ __forceinline__ T block_excl_sum(T v, T* warp_tot, T& total) {
  constexpr int kWarps = NT / 32;
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  T x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const T y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_tot[wid] = x;
  __syncthreads();
  if (wid == 0) {
    T t = lane < kWarps ? warp_tot[lane] : T(0);
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const T y = __shfl_up_sync(0xffffffffu, t, o);
      if (lane >= o) t += y;
    }
    if (lane < kWarps) warp_tot[lane] = t;
  }
  __syncthreads();
  const T excl = (wid ? warp_tot[wid - 1] : T(0)) + x - v;
  total = warp_tot[kWarps - 1];
  __syncthreads();
  return excl;
}

// The last block of a histogram launch to finish turns counts [T][D]
// (tile-major) into each (tile, digit)'s output offset: the digits before
// it over all tiles plus the same digit in the tiles before.
__device__ __forceinline__ void offsets_scan(int* counts, int T,
                                             unsigned long long* done) {
  constexpr int D = kDigits;
  constexpr int kDig = (D + kSortThreads - 1) / kSortThreads;
  __shared__ bool s_last;
  __shared__ int warp_i[kSortWarps];
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    s_last = atomicAdd(done, 1ull) == static_cast<unsigned long long>(
                                          gridDim.x - 1);
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  int tot[kDig];
#pragma unroll
  for (int j = 0; j < kDig; ++j) {
    const int d = threadIdx.x * kDig + j;
    int run = 0;
    if (d < D) {
      for (int t = 0; t < T; ++t) {
        const int c = __ldcg(counts + t * D + d);
        counts[t * D + d] = run;
        run += c;
      }
    }
    tot[j] = run;
  }
  int sum = 0;
#pragma unroll
  for (int j = 0; j < kDig; ++j) sum += tot[j];
  int all;
  int start = block_excl_sum<int, kSortThreads>(sum, warp_i, all);
#pragma unroll
  for (int j = 0; j < kDig; ++j) {
    const int d = threadIdx.x * kDig + j;
    if (d < D)
      for (int t = 0; t < T; ++t) counts[t * D + d] += start;
    start += tot[j];
  }
}

// Walk k-mers [b * kSortTile, (b + 1) * kSortTile): key (range << 26 |
// 13-mer), value the range-local position, in (range, position) order,
// and the first pass's digit counts of the tile.
__global__ void __launch_bounds__(kSortThreads)
seeds_keys_kernel(const uint8_t* __restrict__ seq,
                  const int64_t* __restrict__ kstart,
                  const int64_t* __restrict__ rbase, int n_ranges, int n_t,
                  unsigned long long* __restrict__ key,
                  int* __restrict__ val, int* __restrict__ counts,
                  unsigned long long* __restrict__ done) {
  constexpr int D = kDigits;
  __shared__ int hist[D];
  for (int d = threadIdx.x; d < D; d += kSortThreads) hist[d] = 0;
  __syncthreads();
  const int k0 = blockIdx.x * kSortTile + threadIdx.x * kSortIpt;
  const int k1 = min(k0 + kSortIpt, n_t);
  if (k0 < k1) {
    int r = owner(kstart, n_ranges, k0);
    uint32_t km = 0;
    bool fresh = true;
    for (int k = k0; k < k1; ++k) {
      while (k >= kstart[r + 1]) {
        ++r;
        fresh = true;
      }
      const long long p = k - kstart[r];
      const uint8_t* s = seq + rbase[r] + p;
      if (fresh) {
        km = 0;
#pragma unroll
        for (int j = 0; j < kK; ++j) km = (km << 2) | code2(s[j]);
        fresh = false;
      } else {
        km = ((km << 2) | code2(s[kK - 1])) & kKMask;
      }
      const unsigned long long kk =
          (static_cast<unsigned long long>(r) << (2 * kK)) | km;
      key[k] = kk;
      val[k] = static_cast<int>(p);
      atomicAdd(hist + static_cast<int>(kk & (D - 1)), 1);
    }
  }
  __syncthreads();
  for (int d = threadIdx.x; d < D; d += kSortThreads)
    counts[blockIdx.x * D + d] = hist[d];
  offsets_scan(counts, gridDim.x, done);
}

// The digit counts of each tile of keys at ``shift``, then the offsets.
__global__ void __launch_bounds__(kSortThreads)
seeds_hist_kernel(const unsigned long long* __restrict__ key, int n,
                  int shift, int* __restrict__ counts,
                  unsigned long long* __restrict__ done) {
  constexpr int D = kDigits;
  __shared__ int hist[D];
  for (int d = threadIdx.x; d < D; d += kSortThreads) hist[d] = 0;
  __syncthreads();
  const int end = min(n, static_cast<int>(blockIdx.x + 1) * kSortTile);
  for (int k = blockIdx.x * kSortTile + threadIdx.x; k < end;
       k += kSortThreads)
    atomicAdd(hist + static_cast<int>((key[k] >> shift) & (D - 1)), 1);
  __syncthreads();
  for (int d = threadIdx.x; d < D; d += kSortThreads)
    counts[blockIdx.x * D + d] = hist[d];
  offsets_scan(counts, gridDim.x, done);
}

// One stable LSD pass over tile b's keys at ``shift``: warp w holds the
// tile's keys [w * kWarpItems, (w + 1) * kWarpItems) in kRounds rounds of
// 32; each round groups its lanes by digit (__match_any_sync), the
// group's lowest lane bumps the warp's counter of that digit, and each
// lane's rank is the counter before the round plus its peers below it.
// Slot = the tile's offset of the digit + the warps before it + the rank.
// The last pass writes the 13-mers and positions.
template <bool kLast>
__global__ void __launch_bounds__(kSortThreads)
seeds_scatter_kernel(const unsigned long long* __restrict__ key_in,
                     const int* __restrict__ val_in,
                     unsigned long long* __restrict__ key_out,
                     int* __restrict__ val_out,
                     const int* __restrict__ counts, int n, int shift,
                     uint32_t* __restrict__ skm, int* __restrict__ spos) {
  constexpr int D = kDigits;
  __shared__ unsigned short cnt[kSortWarps * D];
  __shared__ int toff[D];
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  for (int i = threadIdx.x; i < kSortWarps * D; i += kSortThreads) cnt[i] = 0;
  __syncthreads();
  unsigned short* my = cnt + wid * D;
  const unsigned lt = (1u << lane) - 1;
  const int kbase = blockIdx.x * kSortTile + wid * kWarpItems;
  unsigned long long kk[kRounds];
  int vv[kRounds];
  int rk[kRounds];
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    const int k = kbase + r * 32 + lane;
    const bool ok = k < n;
    kk[r] = ok ? key_in[k] : 0ull;
    vv[r] = ok ? val_in[k] : 0;
    const unsigned d =
        ok ? static_cast<unsigned>((kk[r] >> shift) & (D - 1)) : 0xFFFFFFFFu;
    const unsigned peers = __match_any_sync(0xffffffffu, d);
    int b = 0;
    if (ok) b = my[d];
    __syncwarp();
    if (ok && (peers & lt) == 0)
      my[d] = static_cast<unsigned short>(b + __popc(peers));
    __syncwarp();
    rk[r] = b + __popc(peers & lt);
  }
  __syncthreads();
  for (int d = threadIdx.x; d < D; d += kSortThreads) {
    toff[d] = counts[blockIdx.x * D + d];
    int run = 0;
    for (int w2 = 0; w2 < kSortWarps; ++w2) {
      const int c = cnt[w2 * D + d];
      cnt[w2 * D + d] = static_cast<unsigned short>(run);
      run += c;
    }
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    const int k = kbase + r * 32 + lane;
    if (k < n) {
      const int d = static_cast<int>((kk[r] >> shift) & (D - 1));
      const int j = toff[d] + my[d] + rk[r];
      if (kLast) {
        skm[j] = static_cast<uint32_t>(kk[r]) & kKMask;
        spos[j] = vv[r];
      } else {
        key_out[j] = kk[r];
        val_out[j] = vv[r];
      }
    }
  }
}

// Query k-mers [b * kQTile, (b + 1) * kQTile): each one's lower bound in
// its range's slice of the sorted 13-mers and its count (at most 64), and
// the tile's sum of counts.  seg: (row << 32 | range) a segment.
__global__ void __launch_bounds__(kQThreads)
seeds_count_kernel(const uint8_t* __restrict__ rows, long long stride,
                   const int64_t* __restrict__ kstart,
                   const int64_t* __restrict__ qstart,
                   const int64_t* __restrict__ seg, int n_seg, long long n_q,
                   const uint32_t* __restrict__ skm, int* __restrict__ qleft,
                   uint8_t* __restrict__ qcnt, long long* __restrict__ bsum) {
  __shared__ int warp_tot[kQThreads / 32];
  const long long i0 =
      static_cast<long long>(blockIdx.x) * kQTile + threadIdx.x * kQPer;
  int sum = 0;
  if (i0 < n_q) {
    int s = owner(qstart, n_seg, i0);
    long long qs = qstart[s], qe = qstart[s + 1];
    bool fresh = true;
    const uint8_t* row = nullptr;
    long long lo = 0, hi = 0;
    uint32_t km = 0;
    for (int e = 0; e < kQPer; ++e) {
      const long long i = i0 + e;
      if (i >= n_q) break;
      while (i >= qe) {
        ++s;
        qs = qe;
        qe = qstart[s + 1];
        fresh = true;
      }
      const long long q = i - qs;
      if (fresh) {
        const unsigned long long sv = static_cast<unsigned long long>(seg[s]);
        const int r = static_cast<int>(sv & 0xffffffffull);
        row = rows + static_cast<long long>(sv >> 32) * stride;
        lo = kstart[r];
        hi = kstart[r + 1];
        km = 0;
#pragma unroll
        for (int j = 0; j < kK; ++j) km = (km << 2) | code2(row[q + j]);
        fresh = false;
      } else {
        km = ((km << 2) | code2(row[q + kK - 1])) & kKMask;
      }
      long long a = lo, b = hi;
      while (a < b) {
        const long long mid = (a + b) >> 1;
        if (__ldg(skm + mid) < km) a = mid + 1; else b = mid;
      }
      int c = 0;
      while (c < kMaxOcc && a + c < hi && __ldg(skm + a + c) == km) ++c;
      qleft[i] = static_cast<int>(a);
      qcnt[i] = static_cast<uint8_t>(c);
      sum += c;
    }
  }
  int total;
  block_excl_sum<int, kQThreads>(sum, warp_tot, total);
  if (threadIdx.x == 0) bsum[blockIdx.x] = total;
}

// One block: the tiles' sums [nb] into their exclusive offsets and the
// total (ctl[0]).
__global__ void __launch_bounds__(kScanThreads)
seeds_scan_kernel(const long long* __restrict__ bsum, int nb,
                  long long* __restrict__ boff, long long* __restrict__ ctl) {
  __shared__ long long warp_tot[kScanThreads / 32];
  long long carry = 0;
  for (int base = 0; base < nb; base += kScanThreads) {
    const int k = base + threadIdx.x;
    const long long v = k < nb ? bsum[k] : 0;
    long long total;
    const long long ex =
        block_excl_sum<long long, kScanThreads>(v, warp_tot, total);
    if (k < nb) boff[k] = carry + ex;
    carry += total;
  }
  if (threadIdx.x == 0) ctl[0] = carry;
}

// Query k-mers of tile b: their hits (tpos, qpos) as int32 pairs at their
// offsets, and each segment's offset at its first k-mer (segment n_seg:
// the total).
__global__ void __launch_bounds__(kQThreads)
seeds_expand_kernel(const int64_t* __restrict__ qstart, int n_seg,
                    long long n_q, const int* __restrict__ qleft,
                    const uint8_t* __restrict__ qcnt,
                    const long long* __restrict__ boff,
                    const long long* __restrict__ ctl,
                    const int* __restrict__ spos,
                    long long* __restrict__ seg_off, int2* __restrict__ hits) {
  __shared__ int warp_tot[kQThreads / 32];
  const long long i0 =
      static_cast<long long>(blockIdx.x) * kQTile + threadIdx.x * kQPer;
  int sum = 0;
#pragma unroll
  for (int e = 0; e < kQPer; ++e)
    if (i0 + e < n_q) sum += qcnt[i0 + e];
  int total;
  const int ex = block_excl_sum<int, kQThreads>(sum, warp_tot, total);
  if (blockIdx.x == 0 && threadIdx.x == 0) seg_off[n_seg] = ctl[0];
  if (i0 >= n_q) return;
  long long off = boff[blockIdx.x] + ex;
  int s = owner(qstart, n_seg, i0);
  long long qs = qstart[s], qe = qstart[s + 1];
  for (int e = 0; e < kQPer; ++e) {
    const long long i = i0 + e;
    if (i >= n_q) break;
    while (i >= qe) {
      ++s;
      qs = qe;
      qe = qstart[s + 1];
    }
    if (i == qs) seg_off[s] = off;
    const int q = static_cast<int>(i - qs);
    const int a = qleft[i], c = qcnt[i];
    for (int j = 0; j < c; ++j) hits[off + j] = make_int2(spos[a + j], q);
    off += c;
  }
}

int n_passes(int bits) { return (bits + kDigitBits - 1) / kDigitBits; }

}  // namespace

// Constants the wrapper checks: keys a sort tile, query k-mers a tile.
extern "C" int gaml_seeds_sort_tile() { return kSortTile; }
extern "C" int gaml_seeds_query_tile() { return kQTile; }

// The index of n_t walk k-mers over n_ranges ranges: seq uint8 (the ranges
// concatenated), kstart int64 [n_ranges + 1] (each range's first k-mer,
// sum of max(len - 12, 0) before it), rbase int64 [n_ranges] (each
// range's start in seq); keys of ``bits`` bits (26 + the range's bits).
// Scratch: key0/key1 uint64 [n_t], val0/val1 int32 [n_t], counts int32
// [tiles * 256], done uint64 [8] (zeroed here).  Out: skm uint32 [n_t],
// spos int32 [n_t].  Returns the launches' CUDA error, 0 on success.
extern "C" int gaml_seeds_index(const void* seq, const void* kstart,
                                const void* rbase, int n_ranges, int n_t,
                                int bits, void* key0, void* key1, void* val0,
                                void* val1, void* counts, void* done,
                                void* skm, void* spos, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int passes = n_passes(bits);
  if (n_t < 1 || n_ranges < 1 || bits < 2 * kK || passes > kMaxPasses)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaMemsetAsync(
      done, 0, sizeof(unsigned long long) * kMaxPasses, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int T = (n_t + kSortTile - 1) / kSortTile;
  unsigned long long* keys[2] = {static_cast<unsigned long long*>(key0),
                                 static_cast<unsigned long long*>(key1)};
  int* vals[2] = {static_cast<int*>(val0), static_cast<int*>(val1)};
  int* cnt = static_cast<int*>(counts);
  unsigned long long* dn = static_cast<unsigned long long*>(done);
  seeds_keys_kernel<<<T, kSortThreads, 0, st>>>(
      static_cast<const uint8_t*>(seq), static_cast<const int64_t*>(kstart),
      static_cast<const int64_t*>(rbase), n_ranges, n_t, keys[0], vals[0],
      cnt, dn);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  auto mid = seeds_scatter_kernel<false>;
  auto last = seeds_scatter_kernel<true>;
  for (int p = 0; p < passes; ++p) {
    const unsigned long long* src = keys[p % 2];
    if (p) {
      seeds_hist_kernel<<<T, kSortThreads, 0, st>>>(src, n_t, p * kDigitBits,
                                                    cnt, dn + p);
      err = cudaGetLastError();
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    const auto kernel = p == passes - 1 ? last : mid;
    kernel<<<T, kSortThreads, 0, st>>>(
        src, vals[p % 2], keys[1 - p % 2], vals[1 - p % 2], cnt, n_t,
        p * kDigitBits, static_cast<uint32_t*>(skm), static_cast<int*>(spos));
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

// The query's bounds and counts, the tiles' offsets and the total: rows
// uint8 [*, stride] (the resident read rows), kstart as above, qstart
// int64 [n_seg + 1] (each segment's first query k-mer; every segment has
// at least one), seg int64 [n_seg] (row << 32 | range), skm from
// gaml_seeds_index.  Scratch: qleft int32 [n_q], qcnt uint8 [n_q], bsum
// and boff int64 [tiles], ctl int64 [1].  The total is copied to
// ``host_total`` (pinned int64); the caller waits for the stream.
extern "C" int gaml_seeds_count(const void* rows, long long stride,
                                const void* kstart, const void* qstart,
                                const void* seg, int n_seg, long long n_q,
                                const void* skm, void* qleft, void* qcnt,
                                void* bsum, void* boff, void* ctl,
                                void* host_total, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n_seg < 1 || n_q < 1) return static_cast<int>(cudaErrorInvalidValue);
  const long long tiles = (n_q + kQTile - 1) / kQTile;
  if (tiles > 0x7fffffffll) return static_cast<int>(cudaErrorInvalidValue);
  const int nb = static_cast<int>(tiles);
  seeds_count_kernel<<<nb, kQThreads, 0, st>>>(
      static_cast<const uint8_t*>(rows), stride,
      static_cast<const int64_t*>(kstart), static_cast<const int64_t*>(qstart),
      static_cast<const int64_t*>(seg), n_seg, n_q,
      static_cast<const uint32_t*>(skm), static_cast<int*>(qleft),
      static_cast<uint8_t*>(qcnt), static_cast<long long*>(bsum));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  seeds_scan_kernel<<<1, kScanThreads, 0, st>>>(
      static_cast<const long long*>(bsum), nb, static_cast<long long*>(boff),
      static_cast<long long*>(ctl));
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaMemcpyAsync(host_total, ctl, sizeof(long long),
                                          cudaMemcpyDeviceToHost, st));
}

// After the wait: out int64 [n_seg + 1 + total] gets each segment's
// first hit (and the total) in its first n_seg + 1 words and the hits
// (tpos, qpos) as int32 pairs after them; all of it is copied to
// ``host_out`` (pinned, as large) in one copy.
extern "C" int gaml_seeds_expand(const void* qstart, int n_seg, long long n_q,
                                 const void* qleft, const void* qcnt,
                                 const void* boff, const void* ctl,
                                 const void* spos, long long total, void* out,
                                 void* host_out, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n_seg < 1 || n_q < 1 || total < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int nb = static_cast<int>((n_q + kQTile - 1) / kQTile);
  long long* o = static_cast<long long*>(out);
  seeds_expand_kernel<<<nb, kQThreads, 0, st>>>(
      static_cast<const int64_t*>(qstart), n_seg, n_q,
      static_cast<const int*>(qleft), static_cast<const uint8_t*>(qcnt),
      static_cast<const long long*>(boff),
      static_cast<const long long*>(ctl), static_cast<const int*>(spos), o,
      reinterpret_cast<int2*>(o + n_seg + 1));
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaMemcpyAsync(
      host_out, out, sizeof(long long) * (n_seg + 1 + total),
      cudaMemcpyDeviceToHost, st));
}
