// Candidate generation for the short-read rescore on Hopper (sm_90a): the
// max-hash window query against the resident fingerprint CSR.
//
// Replaces no Pallas kernel: the JAX package computes this as an XLA graph
// (gaml_tpu/ops/candgen_device.py:91-278), and the port's first form was a
// chain of about 270 small torch kernels and copies with three host
// synchronisations (ops/candgen_device.py::DeviceCandGen.query_plain, the
// plain version).  What it computes is the reference's
// GetMinHashWithPoses / GetReadCandsWithPoses (graph.cc:1289-1348): on
// each strand (the reverse one is every segment reverse-complemented in
// place), for every window start s whose read-length window [s, s+L) lies
// inside one segment, the max over the window's w = L - K + 1 k-mer starts
// of (hash ^ HASH_XOR, first start wins ties); a new run starts where the
// segment or the fingerprint changes from s - 1; each run is looked up in
// the sorted fingerprints, and every read of its CSR list becomes a
// candidate (read id, window-local seed start g0, orientation, segment),
// emitted forward runs first, then reverse runs, each in window order and
// CSR order.  The caller sorts stably by (segment << 32 | read id).
//
// Design.  Three passes and a finish, every slot from a scan (no
// atomics), so the output is deterministic:
// - candgen_runs_kernel: one block per tile of kTile window starts and
//   strand.  It holds the tile's codes plus a halo of L codes (the
//   predecessor of its first start and the L - 1 codes past its last) in
//   shared memory, with each code's segment (a binary search in seg_base
//   over the segments the tile touches), forms the 30-bit hashes, takes
//   the window max by doubling (a sparse table, log2(w) + 1 passes over the
//   tile, ping-pong in shared memory), flags the runs that start in the
//   tile and have hits, compacts them in window order (a block scan) and
//   writes per run (g0, segment, CSR start, count) into the tile's own
//   region of the run table, and per tile its run and candidate counts.
// - candgen_scan_kernel: one block scans the tiles' candidate counts
//   (strand-major, so forward runs come first) into offsets and writes the
//   total, which the caller copies to pinned host memory: the query's one
//   host synchronisation.
// - candgen_expand_kernel: one block per tile scans its runs' counts and
//   writes each candidate of the tile (one thread a candidate, its run by
//   a binary search over the prefix) at its slot: the sort key (segment <<
//   32 | read id) and (g0 << 1 | orientation).
// - candgen_finish_kernel: after the caller's stable sort of the keys, one
//   thread per candidate writes rid, g0, r0 (the read's seed position of
//   that orientation), orientation and segment in sorted order.
//
// What bounds it on an H100: neither bytes (a code is read once a strand
// with a halo of L / kTile, a run probes about log2(fingerprints) sectors
// of the CSR, a candidate writes 56 bytes in all) nor operations (15
// shifts and ors a hash, about 2 log2(w) max steps a position) come near
// a millisecond at 2.8 Mb; the launches and the host synchronisation set
// its time on the anneal's batches, and the sort on the large worlds.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kK = 15;                   // index k-mer (K_INDEX_KMER)
constexpr uint32_t kHashXor = 0x2204ABCDu;
constexpr int kTile = 1024;              // window starts per block
constexpr int kThreads = 256;
constexpr int kPer = kTile / kThreads;   // consecutive starts a thread
constexpr int kScanThreads = 1024;

// Largest i in [lo, hi] with seg_base[i] <= p (seg_base[lo] <= p).
__device__ __forceinline__ int seg_of(const int64_t* seg_base, int lo, int hi,
                                      int64_t p) {
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (seg_base[mid] <= p) lo = mid; else hi = mid - 1;
  }
  return lo;
}

// Exclusive block scan of one value a thread; ``total`` gets the block's
// sum.  ``warp_tot`` holds NT / 32 values of shared memory.
template <typename T, int NT>
__device__ __forceinline__ T block_excl_scan(T v, T* warp_tot, T& total) {
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
  const T excl = x - v + (wid ? warp_tot[wid - 1] : T(0));
  total = warp_tot[kWarps - 1];
  __syncthreads();
  return excl;
}

__global__ void __launch_bounds__(kThreads)
candgen_runs_kernel(const uint8_t* __restrict__ codes,
                    const int64_t* __restrict__ seg_base,
                    const int64_t* __restrict__ seg_len, int n_seg, int g,
                    int L, const int64_t* __restrict__ sf, int n_fp,
                    const int64_t* __restrict__ off, int4* __restrict__ runs,
                    int* __restrict__ tile_runs,
                    long long* __restrict__ tile_cands) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int w = L - kK + 1;
  const int nk = kTile + w;     // k-mer starts held: base .. base + nk - 1
  const int nc = kTile + L;     // codes held: base .. base + nc - 1
  unsigned long long* keys_a = reinterpret_cast<unsigned long long*>(smem);
  unsigned long long* keys_b = keys_a + nk;
  int* pid = reinterpret_cast<int*>(keys_b + nk);
  uint8_t* v = reinterpret_cast<uint8_t*>(pid + nc);
  __shared__ int seg_range[2];
  __shared__ int warp_i[kThreads / 32];
  __shared__ long long warp_l[kThreads / 32];

  const int strand = blockIdx.y;
  const int tile = blockIdx.x;
  const int t0 = tile * kTile;
  const int base = t0 - 1;  // the predecessor of the tile's first start
  const int tid = threadIdx.x;

  // the segments the held codes touch
  if (tid < 2) {
    const int64_t p = tid == 0 ? max(base, 0) : min(base + nc - 1, g - 1);
    seg_range[tid] = seg_of(seg_base, 0, n_seg - 1, p);
  }
  __syncthreads();
  const int s_lo = seg_range[0], s_hi = seg_range[1];
  for (int q = tid; q < nc; q += kThreads) {
    const int p = base + q;
    int s = -1, c = 0;
    if (p >= 0 && p < g) {
      s = seg_of(seg_base, s_lo, s_hi, p);
      if (strand) {
        const int64_t sb = seg_base[s];
        c = codes[sb + seg_len[s] - 1 - (p - sb)];
        c = c < 4 ? 3 - c : c;
      } else {
        c = codes[p];
      }
      c = c < 4 ? c : 0;  // N hashes as 0
    }
    pid[q] = s;
    v[q] = static_cast<uint8_t>(c);
  }
  __syncthreads();
  for (int i = tid; i < nk; i += kThreads) {
    uint32_t h = 0;
#pragma unroll
    for (int j = 0; j < kK; ++j) h = (h << 2) | v[i + j];
    h ^= kHashXor;
    // the low half is the complemented position: the first start wins ties
    keys_a[i] = (static_cast<unsigned long long>(h) << 32) |
                (0xFFFFFFFFu - static_cast<uint32_t>(base + i));
  }
  __syncthreads();
  // window max by doubling: after the passes keys[i] is the max over
  // [i, i + w) for every i <= kTile (entries past that are not needed)
  unsigned long long* a = keys_a;
  unsigned long long* b = keys_b;
  int size = 1;
  while (true) {
    int d;
    if (size * 2 <= w) {
      d = size;
      size *= 2;
    } else if (size < w) {
      d = w - size;
      size = w;
    } else {
      break;
    }
    for (int i = tid; i < nk - d; i += kThreads) b[i] = max(a[i], a[i + d]);
    __syncthreads();
    unsigned long long* t = a;
    a = b;
    b = t;
  }

  // runs that start in this tile and have hits, kPer consecutive starts a
  // thread, in window order
  int4 rec[kPer];
  bool hit[kPer];
  int n_hit = 0;
  long long n_cand = 0;
#pragma unroll
  for (int e = 0; e < kPer; ++e) {
    const int i = 1 + tid * kPer + e;  // local index of start s
    const int s = base + i;
    hit[e] = false;
    if (s >= g) continue;
    const int p = pid[i];
    if (p < 0 || pid[i + L - 1] != p) continue;  // window leaves the segment
    const unsigned long long key = a[i];
    const long long fp = static_cast<long long>(key >> 32);
    if (pid[i - 1] == p && static_cast<long long>(a[i - 1] >> 32) == fp)
      continue;  // the run of s - 1 goes on
    int lo = 0, hi = n_fp;  // lower bound in sf[0..n_fp] (sf[n_fp]: pad)
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (sf[mid] < fp) lo = mid + 1; else hi = mid;
    }
    if (sf[lo] != fp) continue;
    const int64_t csr = off[lo];
    const int cnt = static_cast<int>(off[lo + 1] - csr);
    if (cnt <= 0) continue;
    const int kp = static_cast<int>(0xFFFFFFFFu - static_cast<uint32_t>(key));
    const int loc = static_cast<int>(kp - seg_base[p]);
    const int g0 = strand ? static_cast<int>(seg_len[p]) - loc - kK : loc;
    rec[e] = make_int4(g0, p, static_cast<int>(csr), cnt);
    hit[e] = true;
    ++n_hit;
    n_cand += cnt;
  }
  int runs_total;
  const int slot = block_excl_scan<int, kThreads>(n_hit, warp_i, runs_total);
  long long cands_total;
  block_excl_scan<long long, kThreads>(n_cand, warp_l, cands_total);
  const int t = strand * gridDim.x + tile;
  int4* out = runs + static_cast<size_t>(t) * kTile + slot;
  int k = 0;
#pragma unroll
  for (int e = 0; e < kPer; ++e)
    if (hit[e]) out[k++] = rec[e];
  if (tid == 0) {
    tile_runs[t] = runs_total;
    tile_cands[t] = cands_total;
  }
}

__global__ void __launch_bounds__(kScanThreads)
candgen_scan_kernel(const long long* __restrict__ tile_cands, int n,
                    long long* __restrict__ cand_off,
                    long long* __restrict__ total) {
  __shared__ long long warp_l[kScanThreads / 32];
  long long carry = 0;
  for (int b = 0; b < n; b += kScanThreads) {
    const int i = b + threadIdx.x;
    long long tot;
    const long long excl = block_excl_scan<long long, kScanThreads>(
        i < n ? tile_cands[i] : 0, warp_l, tot);
    if (i < n) cand_off[i] = carry + excl;
    carry += tot;
  }
  if (threadIdx.x == 0) *total = carry;
}

__global__ void __launch_bounds__(kThreads)
candgen_expand_kernel(const int4* __restrict__ runs,
                      const int* __restrict__ tile_runs,
                      const long long* __restrict__ cand_off,
                      const int64_t* __restrict__ rids,
                      long long* __restrict__ key,
                      long long* __restrict__ val) {
  __shared__ int4 rec[kTile];
  __shared__ long long pre[kTile];
  __shared__ long long warp_l[kThreads / 32];
  const int strand = blockIdx.y;
  const int t = strand * gridDim.x + blockIdx.x;
  const int r = tile_runs[t];
  if (r == 0) return;
  const int4* rr = runs + static_cast<size_t>(t) * kTile;
  const int tid = threadIdx.x;
  long long sum = 0;
#pragma unroll
  for (int e = 0; e < kPer; ++e) {
    const int j = tid * kPer + e;
    if (j < r) {
      rec[j] = rr[j];
      sum += rec[j].w;
    }
  }
  long long total;
  long long run = block_excl_scan<long long, kThreads>(sum, warp_l, total);
#pragma unroll
  for (int e = 0; e < kPer; ++e) {
    const int j = tid * kPer + e;
    if (j < r) {
      pre[j] = run;
      run += rec[j].w;
    }
  }
  __syncthreads();
  const long long c0 = cand_off[t];
  for (long long k = tid; k < total; k += kThreads) {
    int lo = 0, hi = r - 1;  // the last run with pre <= k
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (pre[mid] <= k) lo = mid; else hi = mid - 1;
    }
    const int4 q = rec[lo];
    const long long rid = rids[q.z + (k - pre[lo])];
    key[c0 + k] = (static_cast<long long>(q.y) << 32) | rid;
    val[c0 + k] = (static_cast<long long>(q.x) << 1) | strand;
  }
}

__global__ void __launch_bounds__(kThreads)
candgen_finish_kernel(const long long* __restrict__ skey,
                      const int64_t* __restrict__ order,
                      const long long* __restrict__ val,
                      const int64_t* __restrict__ seed2,
                      const int64_t* __restrict__ row_of, long long n,
                      int64_t* __restrict__ rid_out,
                      int64_t* __restrict__ g0_out,
                      int64_t* __restrict__ r0_out,
                      int64_t* __restrict__ orient_out,
                      int64_t* __restrict__ seg_out) {
  const long long j = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  if (j >= n) return;
  const long long k = skey[j];
  const long long v = val[order[j]];
  const long long rid = k & 0xFFFFFFFFLL;
  const long long o = v & 1;
  rid_out[j] = rid;
  g0_out[j] = v >> 1;
  r0_out[j] = seed2[row_of[rid] * 2 + o];
  orient_out[j] = o;
  seg_out[j] = k >> 32;
}

// Dynamic shared memory of the runs pass: two key buffers, the held
// codes' segments and the codes.
int runs_smem(int L) {
  const int w = L - kK + 1;
  return 2 * (kTile + w) * 8 + (kTile + L) * 5;
}

}  // namespace

// The run table's slots a tile.
extern "C" int gaml_candgen_tile() { return kTile; }

// codes uint8 [g]; seg_base, seg_len int64 [n_seg]; sf int64 [n_fp + 1]
// (sorted fingerprints and a pad above them all); off int64 [n_fp + 2]
// (CSR offsets, the last repeated); outputs: runs int4 [2 * n_tiles *
// kTile], tile_runs int32 and tile_cands int64 [2 * n_tiles].
extern "C" int gaml_candgen_runs(const void* codes, const void* seg_base,
                                 const void* seg_len, int n_seg, int g, int L,
                                 const void* sf, int n_fp, const void* off,
                                 int n_tiles, void* runs, void* tile_runs,
                                 void* tile_cands, void* stream) {
  const int smem = runs_smem(L);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        candgen_runs_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  candgen_runs_kernel<<<dim3(n_tiles, 2), kThreads, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(codes),
      static_cast<const int64_t*>(seg_base),
      static_cast<const int64_t*>(seg_len), n_seg, g, L,
      static_cast<const int64_t*>(sf), n_fp, static_cast<const int64_t*>(off),
      static_cast<int4*>(runs), static_cast<int*>(tile_runs),
      static_cast<long long*>(tile_cands));
  return static_cast<int>(cudaGetLastError());
}

// n = 2 * n_tiles; outputs cand_off int64 [n] (exclusive offsets) and
// total int64 [1] (candidates).
extern "C" int gaml_candgen_scan(const void* tile_cands, int n,
                                 void* cand_off, void* total, void* stream) {
  candgen_scan_kernel<<<1, kScanThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(tile_cands), n,
      static_cast<long long*>(cand_off), static_cast<long long*>(total));
  return static_cast<int>(cudaGetLastError());
}

// rids int64 [CSR]; outputs key, val int64 [n_total] in emission order.
extern "C" int gaml_candgen_expand(const void* runs, const void* tile_runs,
                                   const void* cand_off, const void* rids,
                                   int n_tiles, void* key, void* val,
                                   void* stream) {
  candgen_expand_kernel<<<dim3(n_tiles, 2), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int4*>(runs), static_cast<const int*>(tile_runs),
      static_cast<const long long*>(cand_off),
      static_cast<const int64_t*>(rids), static_cast<long long*>(key),
      static_cast<long long*>(val));
  return static_cast<int>(cudaGetLastError());
}

// skey, order: the stable sort of key; seed2 int64 [rows, 2]; row_of int64;
// outputs rid, g0, r0, orient, seg int64 [n] in sorted order.
extern "C" int gaml_candgen_finish(const void* skey, const void* order,
                                   const void* val, const void* seed2,
                                   const void* row_of, long long n,
                                   void* rid, void* g0, void* r0,
                                   void* orient, void* seg, void* stream) {
  const long long blocks = (n + kThreads - 1) / kThreads;
  candgen_finish_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(skey), static_cast<const int64_t*>(order),
      static_cast<const long long*>(val), static_cast<const int64_t*>(seed2),
      static_cast<const int64_t*>(row_of), n, static_cast<int64_t*>(rid),
      static_cast<int64_t*>(g0), static_cast<int64_t*>(r0),
      static_cast<int64_t*>(orient), static_cast<int64_t*>(seg));
  return static_cast<int>(cudaGetLastError());
}
