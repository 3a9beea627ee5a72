// Candidate generation for the short-read rescore on Hopper (sm_90a): the
// max-hash window query against the resident fingerprint CSR, with its
// own stable radix sort.
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
// CSR order, then sorted stably by (segment, read id).
//
// Design.  Every slot comes from a scan with integer sums, so the output
// is deterministic:
// - candgen_runs_kernel, before the query's one host synchronisation: one
//   block per tile of kTile window starts and strand, tiles taken in
//   order from an atomic ticket.  It stages the tile's codes and a halo of
//   L codes in shared memory with cp.async (one contiguous piece on the
//   forward strand, at most three mirrored pieces on the reverse one),
//   finds each code's segment by flagging the segment starts and one
//   block max-scan, forms the 30-bit hashes by a rolling hash, takes the
//   window max by van Herk/Gil-Werman (prefix and suffix maxes in blocks
//   of w, each a segmented scan over the threads' chunks, then one max a
//   start: three passes whatever w is), flags the runs that start in the
//   tile and have hits (the CSR lookup starts from a table of 2^18
//   buckets of the fingerprint's top bits), and publishes the tile's run
//   and candidate counts through a decoupled look-back (the whole block
//   reads a window of predecessors at once), so each tile
//   writes its runs (val = g0 << 1 | strand, segment, CSR start, count,
//   first candidate) into one compact run table in emission order.  The
//   last tile writes the totals; the caller copies the candidate count to
//   pinned host memory and waits for it.
// - the sort, on the compact key segment << rid_bits | read id (32 bits
//   where seg_bits + rid_bits <= 32, else 64), carrying the 32-bit
//   emission index:
//   - up to kBlockMax candidates with 32-bit keys: candgen_block_kernel,
//     one block that expands the run table into shared memory, runs the
//     8-bit LSD passes there (two ping-pong buffers of key and index, and
//     val) and writes rid, g0, r0, orient and segment: one launch after
//     the sync;
//   - else candgen_expand_kernel (one thread's consecutive candidates
//     from one search of the run table, the first pass's per-tile digit
//     histogram), then per pass candgen_scatter_kernel and, between two
//     passes, candgen_hist_kernel.  The last block of each histogram
//     launch turns the counts into the offsets of each (tile, digit).
//     The scatter ranks within the tile by warps: __match_any_sync groups
//     a round's lanes by digit, a counter per warp and digit in shared
//     memory, the warps' prefixes per digit; the last pass writes the five
//     outputs.
//
// What bounds it on an H100: neither bytes (a code is read once a strand
// with a halo of L / kTile, a run probes a few sectors of the CSR, a
// candidate moves a few words a sort pass and writes 40 bytes) nor
// operations (a rolling hash and three maxes a position, a few per
// candidate and pass) come near a millisecond at 2.8 Mb.  Latency does:
// each runs-pass tile is a chain of dependent global round trips and
// barriers (the ticket, the staging, the CSR lookups, the look-back) with
// seven 128-thread blocks an SM, and on small batches the launches and
// the one host synchronisation set the query's time (PERF.md §6).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kK = 15;                   // index k-mer (K_INDEX_KMER)
constexpr uint32_t kHashXor = 0x2204ABCDu;
constexpr uint32_t kHashMask = (1u << (2 * kK)) - 1;
constexpr int kTile = 1024;              // window starts per block
constexpr int kThreads = 128;            // of the runs pass
constexpr int kPer = kTile / kThreads;   // consecutive starts a thread
constexpr int kBucketShift = 12;         // 30-bit fingerprints, 2^18 buckets
constexpr int kStageSlack = 96;          // alignment of three staged pieces

// both sort routes take digits of kDigitBits (11-bit digits were slower
// on an H100, PERF.md §6)
constexpr int kDigitBits = 8;
constexpr int kDigits = 1 << kDigitBits;

// the multi-block sort: kSortIpt candidates a thread, warps of
// kWarpItems consecutive candidates in rounds of 32
constexpr int kSortThreads = 512;
constexpr int kSortIpt = 8;
constexpr int kSortTile = kSortThreads * kSortIpt;
constexpr int kSortWarps = kSortThreads / 32;
constexpr int kWarpItems = kSortTile / kSortWarps;
constexpr int kRounds = kWarpItems / 32;

// the one-block route: 32-bit keys
constexpr int kBlockThreads = 1024;
constexpr int kBlockWarps = kBlockThreads / 32;
constexpr int kBlockMax = 10240;
constexpr int kBlockRounds = kBlockMax / kBlockWarps / 32;

// ctl (int64): the ticket, the run and candidate totals, one done counter
// per histogram launch, then the tiles' run and candidate status words
constexpr int kCtlTicket = 0, kCtlRuns = 1, kCtlCands = 2, kCtlDone = 3;
constexpr int kMaxPasses = 8;
constexpr int kCtlHead = kCtlDone + kMaxPasses;
// a status word: flag in the top two bits, the value below
constexpr unsigned long long kAgg = 1ull << 62, kInc = 2ull << 62;
constexpr unsigned long long kVal = (1ull << 62) - 1;

struct Sum {
  template <typename T>
  __device__ T operator()(T a, T b) const { return a + b; }
};
struct Max {
  template <typename T>
  __device__ T operator()(T a, T b) const { return a > b ? a : b; }
};

// Largest i in [lo, hi] with seg_base[i] <= p (seg_base[lo] <= p).
__device__ __forceinline__ int seg_of(const int64_t* seg_base, int lo, int hi,
                                      int64_t p) {
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (seg_base[mid] <= p) lo = mid; else hi = mid - 1;
  }
  return lo;
}

// Exclusive block scan of one value a thread under ``op`` (identity
// ``id``); ``total`` gets the block's result.  ``warp_tot`` holds NT / 32
// values of shared memory.
template <typename T, int NT, typename Op>
__device__ __forceinline__ T block_excl_scan(T v, T* warp_tot, T& total, T id,
                                             Op op) {
  constexpr int kWarps = NT / 32;
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  T x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const T y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x = op(y, x);
  }
  if (lane == 31) warp_tot[wid] = x;
  __syncthreads();
  if (wid == 0) {
    T t = lane < kWarps ? warp_tot[lane] : id;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const T y = __shfl_up_sync(0xffffffffu, t, o);
      if (lane >= o) t = op(y, t);
    }
    if (lane < kWarps) warp_tot[lane] = t;
  }
  __syncthreads();
  T in_warp = __shfl_up_sync(0xffffffffu, x, 1);
  if (lane == 0) in_warp = id;
  const T excl = op(wid ? warp_tot[wid - 1] : id, in_warp);
  total = warp_tot[kWarps - 1];
  __syncthreads();
  return excl;
}

// Exclusive segmented max-scan over the block's NT threads in thread
// order (``rev``: in reverse order): the max of the values of the threads
// before this one, back to and including the nearest one whose flag is
// set; 0 where there is none.  ``wf``, ``wv``: NT / 32 entries of shared
// memory.
template <int NT>
__device__ __forceinline__ unsigned long long seg_max_excl(
    bool f, unsigned long long v, bool rev, int* wf, unsigned long long* wv) {
  constexpr int kWarps = NT / 32;
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const int vl = rev ? 31 - lane : lane;         // lane in scan order
  const int vw = rev ? kWarps - 1 - wid : wid;   // warp in scan order
  int fi = f;
  unsigned long long vi = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int src = rev ? min(lane + o, 31) : max(lane - o, 0);
    const int fo = __shfl_sync(0xffffffffu, fi, src);
    const unsigned long long vo = __shfl_sync(0xffffffffu, vi, src);
    if (vl >= o) {
      vi = fi ? vi : max(vo, vi);
      fi |= fo;
    }
  }
  const int prev = rev ? min(lane + 1, 31) : max(lane - 1, 0);
  const int fe = __shfl_sync(0xffffffffu, fi, prev);
  unsigned long long ve = __shfl_sync(0xffffffffu, vi, prev);
  if (vl == 0) ve = 0;
  if (vl == 31) {
    wf[vw] = fi;
    wv[vw] = vi;
  }
  __syncthreads();
  if (wid == 0) {  // the warps' totals, exclusive, in scan order
    int tf = lane < kWarps ? wf[lane] : 0;
    unsigned long long tv = lane < kWarps ? wv[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int fo = __shfl_up_sync(0xffffffffu, tf, o);
      const unsigned long long vo = __shfl_up_sync(0xffffffffu, tv, o);
      if (lane >= o) {
        tv = tf ? tv : max(vo, tv);
        tf |= fo;
      }
    }
    unsigned long long ex = __shfl_up_sync(0xffffffffu, tv, 1);
    if (lane == 0) ex = 0;
    if (lane < kWarps) wv[lane] = ex;
  }
  __syncthreads();
  const unsigned long long res = (vl > 0 && fe) ? ve : max(wv[vw], ve);
  __syncthreads();
  return res;
}

__device__ __forceinline__ void publish(unsigned long long* s,
                                        unsigned long long word) {
  *reinterpret_cast<volatile unsigned long long*>(s) = word;
}

// Decoupled look-back by the whole block over two status arrays at once
// (the tiles' run and candidate counts): each tile publishes its
// aggregate (kAgg), then its inclusive prefix (kInc).  Thread i reads
// tile j - i (spinning until it has published), the block finds the
// nearest inclusive prefix in its window of NT tiles and sums the values
// up to it, or all of them and moves back by NT.  Thread 0 gets the sums
// of tiles 0 .. t-1 in ``ex``.  ``s_stop`` holds 2 ints, ``red`` 2 * NT /
// 32 long longs of shared memory.
template <int NT>
__device__ __forceinline__ void look_back(const unsigned long long* st_r,
                                          const unsigned long long* st_c,
                                          int t, long long* ex, int* s_stop,
                                          long long* red) {
  const int tid = threadIdx.x, lane = tid & 31, wid = tid >> 5;
  bool done_r = false, done_c = false;
  long long er = 0, ec = 0;
  for (int j = t - 1; j >= 0 && !(done_r && done_c); j -= NT) {
    const int q = j - tid;
    unsigned long long a = kInc, b = kInc;  // below tile 0: inclusive 0s
    if (q >= 0) {
      const volatile unsigned long long* pr = st_r + q;
      const volatile unsigned long long* pc = st_c + q;
      if (!done_r) do { a = *pr; } while ((a >> 62) == 0);
      if (!done_c) do { b = *pc; } while ((b >> 62) == 0);
    }
    if (tid < 2) s_stop[tid] = NT;
    __syncthreads();
    if (!done_r && (a >> 62) == 2) atomicMin(s_stop, tid);
    if (!done_c && (b >> 62) == 2) atomicMin(s_stop + 1, tid);
    __syncthreads();
    const int stop_r = s_stop[0], stop_c = s_stop[1];
    long long vr = !done_r && tid <= stop_r ? static_cast<long long>(a & kVal)
                                            : 0;
    long long vc = !done_c && tid <= stop_c ? static_cast<long long>(b & kVal)
                                            : 0;
#pragma unroll
    for (int o = 16; o; o >>= 1) {
      vr += __shfl_xor_sync(0xffffffffu, vr, o);
      vc += __shfl_xor_sync(0xffffffffu, vc, o);
    }
    if (lane == 0) {
      red[2 * wid] = vr;
      red[2 * wid + 1] = vc;
    }
    __syncthreads();
    if (tid == 0) {
      for (int w = 0; w < NT / 32; ++w) {
        er += red[2 * w];
        ec += red[2 * w + 1];
      }
    }
    done_r = done_r || stop_r < NT;
    done_c = done_c || stop_c < NT;
    __syncthreads();
  }
  if (tid == 0) {
    ex[0] = er;
    ex[1] = ec;
  }
}

// Copies bytes [src, src + n) to shared memory at dst, where dst and src
// agree modulo 16: cp.async of the 16-byte chunks inside, single bytes at
// both ends.  The caller waits (cp_async_wait).
__device__ __forceinline__ void stage_bytes(uint8_t* dst, const uint8_t* src,
                                            int n) {
  const int a = static_cast<int>(reinterpret_cast<uintptr_t>(src) & 15);
  const int head = min((16 - a) & 15, n);
  const int body = (n - head) & ~15;
  for (int i = threadIdx.x; i < head; i += blockDim.x) dst[i] = src[i];
  for (int i = head + body + threadIdx.x; i < n; i += blockDim.x)
    dst[i] = src[i];
  for (int i = head + 16 * threadIdx.x; i < head + body;
       i += 16 * blockDim.x) {
    const unsigned d =
        static_cast<unsigned>(__cvta_generic_to_shared(dst + i));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
                 "l"(src + i)
                 : "memory");
  }
}

__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
}

// Shared memory of the runs pass: prefix and suffix maxes (8 bytes a
// k-mer start), the held codes' segments (4 bytes) and codes (1 byte),
// then the staged bytes.
__host__ __device__ int runs_raw_offset(int L) {
  const int w = L - kK + 1;
  return (2 * (kTile + w) * 8 + (kTile + L) * 5 + 15) & ~15;
}

int runs_smem(int L) { return runs_raw_offset(L) + kTile + L + kStageSlack; }

__global__ void __launch_bounds__(kThreads)
candgen_runs_kernel(const uint8_t* __restrict__ codes,
                    const int64_t* __restrict__ seg_base,
                    const int64_t* __restrict__ seg_len, int n_seg, int g,
                    int L, const int64_t* __restrict__ sf,
                    const int64_t* __restrict__ off,
                    const int* __restrict__ bucket, int n_tiles,
                    unsigned long long* __restrict__ ctl,
                    int4* __restrict__ runs,
                    long long* __restrict__ run_start) {
  constexpr int NT = kThreads;
  extern __shared__ __align__(16) unsigned char smem[];
  const int w = L - kK + 1;
  const int nk = kTile + w;     // k-mer starts held: base .. base + nk - 1
  const int nc = kTile + L;     // codes held: base .. base + nc - 1
  unsigned long long* pre = reinterpret_cast<unsigned long long*>(smem);
  unsigned long long* suf = pre + nk;
  int* pid = reinterpret_cast<int*>(suf + nk);
  uint8_t* v = reinterpret_cast<uint8_t*>(pid + nc);
  uint8_t* raw = smem + runs_raw_offset(L);
  __shared__ int s_t, s_lo, s_hi;
  __shared__ int p_src[3], p_len[3], p_dst[3];
  __shared__ int warp_i[NT / 32];
  __shared__ long long warp_l[NT / 32];
  __shared__ int seg_f[NT / 32];
  __shared__ unsigned long long seg_v[NT / 32];
  __shared__ long long s_ex[2];
  __shared__ int s_stop[2];
  __shared__ long long s_red[2 * (NT / 32)];

  const int tid = threadIdx.x;
  const int n_rt = 2 * n_tiles;
  if (tid == 0) s_t = static_cast<int>(atomicAdd(ctl + kCtlTicket, 1ull));
  __syncthreads();
  const int t = s_t;
  const int strand = t >= n_tiles;
  const int base = (t - strand * n_tiles) * kTile - 1;  // s0 - 1
  const int lo = max(base, 0), hi = min(base + nc, g);  // held, inside
  if (tid < 2) {
    const int s = seg_of(seg_base, 0, n_seg - 1, tid ? hi - 1 : lo);
    if (tid) s_hi = s; else s_lo = s;
  }
  __syncthreads();
  const int seg_lo = s_lo, seg_hi = s_hi;
  // the pieces of codes to stage: [lo, hi) forward; on the reverse strand
  // the mirror of segment seg_lo's part, the segments between (each its
  // own mirror) and the mirror of seg_hi's part
  if (tid == 0) {
    p_src[0] = lo;
    p_len[0] = hi - lo;
    p_src[1] = p_len[1] = p_src[2] = p_len[2] = 0;
    if (strand) {
      const int sb = static_cast<int>(seg_base[seg_lo]);
      const int sl = static_cast<int>(seg_len[seg_lo]);
      const int x1 = min(hi, sb + sl);
      p_src[0] = 2 * sb + sl - x1;
      p_len[0] = x1 - lo;
      if (seg_hi > seg_lo) {
        const int sbh = static_cast<int>(seg_base[seg_hi]);
        const int slh = static_cast<int>(seg_len[seg_hi]);
        p_src[1] = sb + sl;
        p_len[1] = sbh - (sb + sl);
        p_src[2] = 2 * sbh + slh - hi;
        p_len[2] = hi - sbh;
      }
    }
    int cur = 0;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const int a = static_cast<int>(
          reinterpret_cast<uintptr_t>(codes + p_src[k]) & 15);
      p_dst[k] = ((cur + 15) & ~15) + a;
      cur = p_dst[k] + p_len[k];
    }
  }
  __syncthreads();
  for (int k = 0; k < 3; ++k)
    stage_bytes(raw + p_dst[k], codes + p_src[k], p_len[k]);
  // each held code's segment: seg_lo at lo, every later segment's start
  // flagged, then a max-scan; -1 outside [lo, hi)
  for (int q = tid; q < nc; q += NT) pid[q] = q == lo - base ? seg_lo : -1;
  __syncthreads();
  for (int s = seg_lo + 1 + tid; s <= seg_hi; s += NT)
    atomicMax(pid + (static_cast<int>(seg_base[s]) - base), s);
  __syncthreads();
  {
    const int cc = (nc + NT - 1) / NT;
    const int q0 = min(tid * cc, nc), q1 = min(q0 + cc, nc);
    int m = -1;
    for (int q = q0; q < q1; ++q) m = max(m, pid[q]);
    int all;
    int run = block_excl_scan<int, NT>(m, warp_i, all, -1, Max());
    for (int q = q0; q < q1; ++q) {
      run = max(run, pid[q]);
      pid[q] = base + q < g ? run : -1;
    }
  }
  cp_async_wait();
  __syncthreads();
  for (int q = tid; q < nc; q += NT) {
    const int p = base + q;
    int c = 0;
    if (p >= lo && p < hi) {
      if (strand) {
        const int s = pid[q];
        const int src = static_cast<int>(2 * seg_base[s] + seg_len[s]) - 1 - p;
        const int k = s == seg_lo ? 0 : (s == seg_hi ? 2 : 1);
        c = raw[p_dst[k] + src - p_src[k]];
        c = c < 4 ? 3 - c : c;
      } else {
        c = raw[p_dst[0] + p - lo];
      }
      c = c < 4 ? c : 0;  // N hashes as 0
    }
    v[q] = static_cast<uint8_t>(c);
  }
  __syncthreads();

  // keys (hash << 32 | ~position: the first start wins ties) by a rolling
  // hash over the thread's chunk, with the chunk's summaries for the
  // segmented scans: the max after its last block start (prefix) and up
  // to its first block end (suffix), blocks of w k-mer starts
  const int ck = (nk + NT - 1) / NT;
  const int i0 = min(tid * ck, nk), i1 = min(i0 + ck, nk);
  bool pf = false, sfl = false;
  unsigned long long pv = 0, sv = 0;
  if (i0 < i1) {
    uint32_t h = 0;
    for (int j = 0; j < kK - 1; ++j) h = (h << 2) | v[i0 + j];
    int r = i0 % w;
    for (int i = i0; i < i1; ++i) {
      h = ((h << 2) | v[i + kK - 1]) & kHashMask;
      const unsigned long long key =
          (static_cast<unsigned long long>(h ^ kHashXor) << 32) |
          (0xFFFFFFFFu - static_cast<uint32_t>(base + i));
      pre[i] = key;
      if (r == 0) {
        pf = true;
        pv = key;
      } else {
        pv = max(pv, key);
      }
      if (!sfl) {
        sv = max(sv, key);
        sfl = r == w - 1;
      }
      r = r + 1 == w ? 0 : r + 1;
    }
  }
  const unsigned long long pc = seg_max_excl<NT>(pf, pv, false, seg_f, seg_v);
  const unsigned long long sc = seg_max_excl<NT>(sfl, sv, true, seg_f, seg_v);
  if (i0 < i1) {  // suffix maxes into suf, then prefix maxes in place
    unsigned long long run = sc;
    int r = (i1 - 1) % w;
    for (int i = i1 - 1; i >= i0; --i) {
      const unsigned long long key = pre[i];
      run = r == w - 1 ? key : max(run, key);
      suf[i] = run;
      r = r ? r - 1 : w - 1;
    }
    run = pc;
    r = i0 % w;
    for (int i = i0; i < i1; ++i) {
      const unsigned long long key = pre[i];
      run = r == 0 ? key : max(run, key);
      pre[i] = run;
      r = r + 1 == w ? 0 : r + 1;
    }
  }
  __syncthreads();
  // the max over k-mer starts [i, i + w): suffix of i's block, prefix of
  // the next block's part
  auto wmax = [&](int i) { return max(suf[i], pre[i + w - 1]); };

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
    const unsigned long long key = wmax(i);
    const long long fp = static_cast<long long>(key >> 32);
    if (pid[i - 1] == p && static_cast<long long>(wmax(i - 1) >> 32) == fp)
      continue;  // the run of s - 1 goes on
    // lower bound in sf (sf[n_fp]: pad) inside fp's bucket
    const int b = static_cast<int>(fp >> kBucketShift);
    int lo2 = bucket[b], hi2 = bucket[b + 1];
    while (lo2 < hi2) {
      const int mid = (lo2 + hi2) >> 1;
      if (sf[mid] < fp) lo2 = mid + 1; else hi2 = mid;
    }
    // lo2 <= n_fp: the CSR offsets load beside the check
    const int64_t csr = off[lo2];
    const int cnt = static_cast<int>(off[lo2 + 1] - csr);
    if (sf[lo2] != fp || cnt <= 0) continue;
    const int kp = static_cast<int>(0xFFFFFFFFu - static_cast<uint32_t>(key));
    const int loc = static_cast<int>(kp - seg_base[p]);
    const int g0 = strand ? static_cast<int>(seg_len[p]) - loc - kK : loc;
    rec[e] = make_int4(
        static_cast<int>((static_cast<unsigned>(g0) << 1) | strand), p,
        static_cast<int>(csr), cnt);
    hit[e] = true;
    ++n_hit;
    n_cand += cnt;
  }
  int runs_total;
  const int slot =
      block_excl_scan<int, NT>(n_hit, warp_i, runs_total, 0, Sum());
  long long cands_total;
  const long long cpre = block_excl_scan<long long, NT>(
      n_cand, warp_l, cands_total, 0LL, Sum());
  // the chained scan over tiles (strand-major: forward runs first)
  unsigned long long* st_r = ctl + kCtlHead;
  unsigned long long* st_c = st_r + n_rt;
  if (tid == 0) {
    const unsigned long long f = t ? kAgg : kInc;
    publish(st_r + t, f | static_cast<unsigned long long>(runs_total));
    publish(st_c + t, f | static_cast<unsigned long long>(cands_total));
  }
  if (t) {
    look_back<NT>(st_r, st_c, t, s_ex, s_stop, s_red);
  } else if (tid == 0) {
    s_ex[0] = s_ex[1] = 0;
  }
  if (tid == 0) {
    const long long er = s_ex[0], ec = s_ex[1];
    if (t) {
      publish(st_r + t, kInc | static_cast<unsigned long long>(
                                   er + runs_total));
      publish(st_c + t, kInc | static_cast<unsigned long long>(
                                   ec + cands_total));
    }
    if (t == n_rt - 1) {
      ctl[kCtlRuns] = static_cast<unsigned long long>(er + runs_total);
      ctl[kCtlCands] = static_cast<unsigned long long>(ec + cands_total);
    }
  }
  __syncthreads();
  long long k = s_ex[0] + slot, c = s_ex[1] + cpre;
#pragma unroll
  for (int e = 0; e < kPer; ++e) {
    if (hit[e]) {
      runs[k] = rec[e];
      run_start[k] = c;
      ++k;
      c += rec[e].w;
    }
  }
}

// The last block of a histogram launch to finish turns counts [T][D]
// (tile-major) into each (tile, digit)'s output offset: the digits before
// it over all tiles plus the same digit in the tiles before.  A thread
// scans whole digits over the tiles, loads in batches of 8.
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
      for (int t0 = 0; t0 < T; t0 += 8) {
        int c[8];
#pragma unroll
        for (int u = 0; u < 8; ++u)
          c[u] = t0 + u < T ? __ldcg(counts + (t0 + u) * D + d) : 0;
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          if (t0 + u < T) counts[(t0 + u) * D + d] = run;
          run += c[u];
        }
      }
    }
    tot[j] = run;
  }
  int sum = 0;
#pragma unroll
  for (int j = 0; j < kDig; ++j) sum += tot[j];
  int all;
  int start =
      block_excl_scan<int, kSortThreads>(sum, warp_i, all, 0, Sum());
#pragma unroll
  for (int j = 0; j < kDig; ++j) {
    const int d = threadIdx.x * kDig + j;
    if (d < D) {
      for (int t0 = 0; t0 < T; t0 += 8) {
        int c[8];
#pragma unroll
        for (int u = 0; u < 8; ++u)
          c[u] = t0 + u < T ? __ldcg(counts + (t0 + u) * D + d) : 0;
#pragma unroll
        for (int u = 0; u < 8; ++u)
          if (t0 + u < T) counts[(t0 + u) * D + d] = c[u] + start;
      }
    }
    start += tot[j];
  }
}

// Candidates [b * kSortTile, (b + 1) * kSortTile) of the run table: keys
// (segment << rid_bits | read id) and val (g0 << 1 | strand) in emission
// order, and the first pass's digit counts of the tile.
template <typename KeyT>
__global__ void __launch_bounds__(kSortThreads)
candgen_expand_kernel(const int4* __restrict__ runs,
                      const long long* __restrict__ run_start,
                      unsigned long long* __restrict__ ctl,
                      const int64_t* __restrict__ rids, int n, int rid_bits,
                      KeyT* __restrict__ key, uint32_t* __restrict__ val,
                      int* __restrict__ counts) {
  constexpr int D = kDigits;
  __shared__ int hist[D];
  for (int d = threadIdx.x; d < D; d += kSortThreads) hist[d] = 0;
  __syncthreads();
  const long long n_runs = static_cast<long long>(ctl[kCtlRuns]);
  const int k0 = blockIdx.x * kSortTile + threadIdx.x * kSortIpt;
  const int k1 = min(k0 + kSortIpt, n);
  if (k0 < k1) {
    long long j = 0, hi = n_runs - 1;  // the last run with start <= k0
    while (j < hi) {
      const long long mid = (j + hi + 1) >> 1;
      if (run_start[mid] <= k0) j = mid; else hi = mid - 1;
    }
    int4 q = runs[j];
    long long st = run_start[j];
    for (int k = k0; k < k1; ++k) {
      while (k - st >= q.w) {
        ++j;
        q = runs[j];
        st = run_start[j];
      }
      const unsigned long long rid =
          static_cast<unsigned long long>(rids[q.z + (k - st)]);
      const KeyT kk = static_cast<KeyT>(
          (static_cast<unsigned long long>(q.y) << rid_bits) | rid);
      key[k] = kk;
      val[k] = static_cast<uint32_t>(q.x);
      atomicAdd(hist + static_cast<int>(kk & (D - 1)), 1);
    }
  }
  __syncthreads();
  for (int d = threadIdx.x; d < D; d += kSortThreads)
    counts[blockIdx.x * D + d] = hist[d];
  offsets_scan(counts, gridDim.x, ctl + kCtlDone);
}

// The digit counts of each tile of keys at ``shift``, then the offsets.
template <typename KeyT>
__global__ void __launch_bounds__(kSortThreads)
candgen_hist_kernel(const KeyT* __restrict__ key, int n, int shift,
                    int* __restrict__ counts,
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

// One candidate's outputs at its sorted slot j: read id and segment from
// the key, g0 and orientation from val, the read's seed position.
template <typename KeyT>
__device__ __forceinline__ void finish(
    long long j, KeyT kk, uint32_t v, int rid_bits,
    const int64_t* __restrict__ seed2, const int64_t* __restrict__ row_of,
    int64_t* rid_out, int64_t* g0_out, int64_t* r0_out, int64_t* orient_out,
    int64_t* seg_out) {
  const unsigned long long k64 = kk;
  const long long rid = static_cast<long long>(
      k64 & ((1ull << rid_bits) - 1));
  const int o = v & 1;
  rid_out[j] = rid;
  g0_out[j] = v >> 1;
  r0_out[j] = seed2[row_of[rid] * 2 + o];
  orient_out[j] = o;
  seg_out[j] = static_cast<long long>(k64 >> rid_bits);
}

// One stable LSD pass over tile b's keys at ``shift``: warp w holds the
// tile's candidates [w * kWarpItems, (w + 1) * kWarpItems) in kRounds
// rounds of 32; each round groups its lanes by digit (__match_any_sync),
// the group's lowest lane bumps the warp's counter of that digit, and each
// lane's rank is the counter before the round plus its peers below it.
// Slot = the tile's offset of the digit + the warps before it + the rank.
// The first pass carries each candidate's own index (idx_in null); the
// last writes the five outputs.
template <typename KeyT, bool kLast>
__global__ void __launch_bounds__(kSortThreads)
candgen_scatter_kernel(const KeyT* __restrict__ key_in,
                       const uint32_t* __restrict__ idx_in,
                       KeyT* __restrict__ key_out,
                       uint32_t* __restrict__ idx_out,
                       const int* __restrict__ counts, int n, int shift,
                       int rid_bits, const uint32_t* __restrict__ val,
                       const int64_t* __restrict__ seed2,
                       const int64_t* __restrict__ row_of, int64_t* rid_out,
                       int64_t* g0_out, int64_t* r0_out, int64_t* orient_out,
                       int64_t* seg_out) {
  constexpr int D = kDigits;
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned short* cnt = reinterpret_cast<unsigned short*>(smem);  // [W][D]
  __shared__ int toff[D];
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  for (int i = threadIdx.x; i < kSortWarps * D; i += kSortThreads) cnt[i] = 0;
  __syncthreads();
  unsigned short* my = cnt + wid * D;
  const unsigned lt = (1u << lane) - 1;
  const int kbase = blockIdx.x * kSortTile + wid * kWarpItems;
  KeyT kk[kRounds];
  uint32_t ix[kRounds];
  int rk[kRounds];
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    const int k = kbase + r * 32 + lane;
    const bool ok = k < n;
    kk[r] = ok ? key_in[k] : KeyT(0);
    ix[r] = ok ? (idx_in ? idx_in[k] : static_cast<uint32_t>(k)) : 0u;
    const unsigned d =
        ok ? static_cast<unsigned>((kk[r] >> shift) & (D - 1)) : 0xFFFFFFFFu;
    const unsigned peers = __match_any_sync(0xffffffffu, d);
    int b = 0;
    if (ok) b = my[d];
    __syncwarp();
    if (ok && (peers & lt) == 0) my[d] = static_cast<unsigned short>(
        b + __popc(peers));
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
        finish(j, kk[r], val[ix[r]], rid_bits, seed2, row_of, rid_out,
               g0_out, r0_out, orient_out, seg_out);
      } else {
        key_out[j] = kk[r];
        idx_out[j] = ix[r];
      }
    }
  }
}

// Shared memory of the one-block route: two ping-pong buffers of key and
// index and val (20 bytes a candidate), a counter per warp and digit.
int block_smem(int n) {
  return 20 * n + kBlockWarps * kDigits * 2;
}

// The whole sort after the sync in one block, for n <= kBlockMax
// candidates and 32-bit keys: the expansion into shared memory (key,
// index and val; the run starts staged in the second key buffer for the
// search), then ``passes``
// LSD passes between the buffers (warp w holds candidates
// [w * C, (w + 1) * C), C a multiple of 32; ranks as in
// candgen_scatter_kernel, the digits' starts by a block scan), the last
// writing the five outputs.
__global__ void __launch_bounds__(kBlockThreads)
candgen_block_kernel(const unsigned long long* __restrict__ ctl,
                     const int4* __restrict__ runs,
                     const long long* __restrict__ run_start,
                     const int64_t* __restrict__ rids, int n, int rid_bits,
                     int passes, const int64_t* __restrict__ seed2,
                     const int64_t* __restrict__ row_of, int64_t* rid_out,
                     int64_t* g0_out, int64_t* r0_out, int64_t* orient_out,
                     int64_t* seg_out) {
  constexpr int D = kDigits;
  extern __shared__ __align__(16) unsigned char smem[];
  uint32_t* key_a = reinterpret_cast<uint32_t*>(smem);
  uint32_t* idx_a = key_a + n;
  uint32_t* key_b = idx_a + n;
  uint32_t* idx_b = key_b + n;
  uint32_t* val = idx_b + n;
  unsigned short* cnt = reinterpret_cast<unsigned short*>(val + n);
  __shared__ int toff[D];
  __shared__ int warp_i[kBlockWarps];
  const int tid = threadIdx.x, lane = tid & 31, wid = tid >> 5;

  const int n_runs = static_cast<int>(ctl[kCtlRuns]);  // <= n
  uint32_t* rs = key_b;
  for (int j = tid; j < n_runs; j += kBlockThreads)
    rs[j] = static_cast<uint32_t>(run_start[j]);
  __syncthreads();
  const int per = (n + kBlockThreads - 1) / kBlockThreads;
  const int k0 = min(tid * per, n), k1 = min(k0 + per, n);
  if (k0 < k1) {
    int j = 0, hi = n_runs - 1;  // the last run with start <= k0
    while (j < hi) {
      const int mid = (j + hi + 1) >> 1;
      if (rs[mid] <= static_cast<uint32_t>(k0)) j = mid; else hi = mid - 1;
    }
    int4 q = runs[j];
    int st = static_cast<int>(rs[j]);
    for (int k = k0; k < k1; ++k) {
      while (k - st >= q.w) {
        ++j;
        q = runs[j];
        st = static_cast<int>(rs[j]);
      }
      const unsigned long long rid =
          static_cast<unsigned long long>(rids[q.z + (k - st)]);
      key_a[k] = static_cast<uint32_t>(
          (static_cast<unsigned long long>(q.y) << rid_bits) | rid);
      idx_a[k] = static_cast<uint32_t>(k);
      val[k] = static_cast<uint32_t>(q.x);
    }
  }
  __syncthreads();

  const int C = ((n + kBlockWarps - 1) / kBlockWarps + 31) & ~31;
  const int kbase = wid * C;
  unsigned short* my = cnt + wid * D;
  const unsigned lt = (1u << lane) - 1;
  for (int pass = 0; pass < passes; ++pass) {
    const int shift = pass * kDigitBits;
    for (int i = tid; i < kBlockWarps * D; i += kBlockThreads) cnt[i] = 0;
    __syncthreads();
    int rk[kBlockRounds];
#pragma unroll
    for (int r = 0; r < kBlockRounds; ++r) {
      const int k = kbase + r * 32 + lane;
      const bool ok = r * 32 < C && k < n;
      const unsigned d = ok ? (key_a[k] >> shift) & (D - 1) : 0xFFFFFFFFu;
      const unsigned peers = __match_any_sync(0xffffffffu, d);
      int b = 0;
      if (ok) b = my[d];
      __syncwarp();
      if (ok && (peers & lt) == 0) my[d] = static_cast<unsigned short>(
          b + __popc(peers));
      __syncwarp();
      rk[r] = b + __popc(peers & lt);
    }
    __syncthreads();
    int tot = 0;
    if (tid < D) {
      for (int w2 = 0; w2 < kBlockWarps; ++w2) {
        const int c = cnt[w2 * D + tid];
        cnt[w2 * D + tid] = static_cast<unsigned short>(tot);
        tot += c;
      }
    }
    int all;
    const int start = block_excl_scan<int, kBlockThreads>(tot, warp_i, all,
                                                          0, Sum());
    if (tid < D) toff[tid] = start;
    __syncthreads();
    const bool last = pass == passes - 1;
#pragma unroll
    for (int r = 0; r < kBlockRounds; ++r) {
      const int k = kbase + r * 32 + lane;
      if (r * 32 < C && k < n) {
        const uint32_t kk = key_a[k];
        const int d = static_cast<int>((kk >> shift) & (D - 1));
        const int j = toff[d] + my[d] + rk[r];
        if (last) {
          finish(j, kk, val[idx_a[k]], rid_bits, seed2, row_of, rid_out,
                 g0_out, r0_out, orient_out, seg_out);
        } else {
          key_b[j] = kk;
          idx_b[j] = idx_a[k];
        }
      }
    }
    __syncthreads();
    uint32_t* t = key_a;
    key_a = key_b;
    key_b = t;
    t = idx_a;
    idx_a = idx_b;
    idx_b = t;
  }
}

// Raises ``kernel``'s dynamic shared memory limit on the current device
// to ``bytes`` where it is lower: ``set`` remembers the largest limit set
// on each of the first kDevices devices.
constexpr int kDevices = 16;
template <typename F>
int smem_attr(F kernel, int bytes, int* set) {
  if (bytes <= 48 * 1024) return 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < kDevices && bytes <= set[dev]) return 0;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess && dev < kDevices) set[dev] = bytes;
  return static_cast<int>(err);
}

// The workspace of a query (int64 words): ctl, then the run table's int4
// records (16-byte aligned) and first candidates, 2 * n_tiles * kTile
// each.
struct Workspace {
  unsigned long long* ctl;
  int4* runs;
  long long* run_start;
  static size_t runs_at(int n_tiles) {  // an even word: 16-byte aligned
    return (kCtlHead + 4 * static_cast<size_t>(n_tiles) + 1) & ~1ull;
  }
  static size_t slots(int n_tiles) {
    return 2 * static_cast<size_t>(n_tiles) * kTile;
  }
  static size_t words(int n_tiles) {
    return runs_at(n_tiles) + 3 * slots(n_tiles);
  }
  Workspace(void* ws, int n_tiles) {
    long long* w = static_cast<long long*>(ws);
    ctl = reinterpret_cast<unsigned long long*>(w);
    runs = reinterpret_cast<int4*>(w + runs_at(n_tiles));
    run_start = w + runs_at(n_tiles) + 2 * slots(n_tiles);
  }
};

size_t align16(size_t b) { return (b + 15) & ~static_cast<size_t>(15); }

// The radix route's scratch (bytes): two key buffers, two index buffers,
// val, the counts of each (tile, digit).
struct Scratch {
  void* key[2];
  uint32_t* idx[2];
  uint32_t* val;
  int* counts;
  Scratch(void* base, int n, int key_bytes) {
    char* p = static_cast<char*>(base);
    const size_t k = align16(static_cast<size_t>(n) * key_bytes);
    const size_t i = align16(static_cast<size_t>(n) * 4);
    key[0] = p;
    key[1] = p + k;
    idx[0] = reinterpret_cast<uint32_t*>(p + 2 * k);
    idx[1] = reinterpret_cast<uint32_t*>(p + 2 * k + i);
    val = reinterpret_cast<uint32_t*>(p + 2 * k + 2 * i);
    counts = reinterpret_cast<int*>(p + 2 * k + 3 * i);
  }
  static size_t bytes(int n, int key_bytes) {
    const size_t t = (static_cast<size_t>(n) + kSortTile - 1) / kSortTile;
    return 2 * align16(static_cast<size_t>(n) * key_bytes) +
           3 * align16(static_cast<size_t>(n) * 4) + t * kDigits * 4;
  }
};

// The LSD passes of ``bits`` bits, the passes of both routes.
int n_passes(int bits) {
  return bits > kDigitBits ? (bits + kDigitBits - 1) / kDigitBits : 1;
}

// The radix route after the sync: the expansion (with the first pass's
// counts and offsets), then the passes (a histogram launch between two,
// a scatter each, the last one writing ``out``).
template <typename KeyT>
int radix(const Workspace& ws, const int64_t* rids, const int64_t* seed2,
          const int64_t* row_of, int n, int rid_bits, int bits,
          const Scratch& sc, int64_t* const* out, cudaStream_t st) {
  const int T = (n + kSortTile - 1) / kSortTile;
  const int passes = n_passes(bits);
  if (passes > kMaxPasses) return static_cast<int>(cudaErrorInvalidValue);
  candgen_expand_kernel<KeyT><<<T, kSortThreads, 0, st>>>(
      ws.runs, ws.run_start, ws.ctl, rids, n, rid_bits,
      static_cast<KeyT*>(sc.key[0]), sc.val, sc.counts);
  const cudaError_t err0 = cudaGetLastError();
  if (err0 != cudaSuccess) return static_cast<int>(err0);
  const int smem = kSortWarps * kDigits * 2;
  auto mid = candgen_scatter_kernel<KeyT, false>;
  auto last = candgen_scatter_kernel<KeyT, true>;
  static int set_mid[kDevices] = {}, set_last[kDevices] = {};
  int err = smem_attr(mid, smem, set_mid);
  if (!err) err = smem_attr(last, smem, set_last);
  if (err) return err;
  for (int p = 0; p < passes; ++p) {
    const KeyT* src = static_cast<const KeyT*>(sc.key[p % 2]);
    if (p) {
      candgen_hist_kernel<KeyT><<<T, kSortThreads, 0, st>>>(
          src, n, p * kDigitBits, sc.counts, ws.ctl + kCtlDone + p);
    }
    const auto kernel = p == passes - 1 ? last : mid;
    kernel<<<T, kSortThreads, smem, st>>>(
        src, p ? sc.idx[p % 2] : nullptr,
        static_cast<KeyT*>(sc.key[1 - p % 2]), sc.idx[1 - p % 2], sc.counts,
        n, p * kDigitBits, rid_bits, sc.val, seed2, row_of, out[0], out[1],
        out[2], out[3], out[4]);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  return 0;
}

}  // namespace

// Constants the wrapper checks: window starts a tile, candidates a sort
// tile, the one-block route's capacity.
extern "C" int gaml_candgen_tile() { return kTile; }
extern "C" int gaml_candgen_sort_tile() { return kSortTile; }
extern "C" int gaml_candgen_block_max() { return kBlockMax; }

// int64 words of a query's workspace over n_tiles tiles a strand, and
// bytes of the radix route's scratch.
extern "C" long long gaml_candgen_ws_words(int n_tiles) {
  return static_cast<long long>(Workspace::words(n_tiles));
}
extern "C" long long gaml_candgen_scratch_bytes(int n, int key64) {
  return static_cast<long long>(Scratch::bytes(n, key64 ? 8 : 4));
}

// codes uint8 [g]; seg_base, seg_len int64 [n_seg]; sf int64 [n_fp + 1]
// (sorted fingerprints and a pad above them all); off int64 [n_fp + 2]
// (CSR offsets, the last repeated); bucket int32 [2^18 + 1] (the lower
// bound in sf of each bucket's first fingerprint); ws int64
// [gaml_candgen_ws_words(n_tiles)], whose ctl is zeroed here.  The
// candidate total is copied to ``count`` (pinned host int64)
// after the pass; the caller waits for the stream before reading it.
extern "C" int gaml_candgen_runs(const void* codes, const void* seg_base,
                                 const void* seg_len, int n_seg, int g, int L,
                                 const void* sf, const void* off,
                                 const void* bucket, int n_tiles, void* ws,
                                 void* count, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Workspace w(ws, n_tiles);
  cudaError_t err = cudaMemsetAsync(
      w.ctl, 0,
      sizeof(long long) * (kCtlHead + 4 * static_cast<size_t>(n_tiles)), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int smem = runs_smem(L);
  static int set[kDevices] = {};
  const int aerr = smem_attr(candgen_runs_kernel, smem, set);
  if (aerr) return aerr;
  candgen_runs_kernel<<<2 * n_tiles, kThreads, smem, st>>>(
      static_cast<const uint8_t*>(codes),
      static_cast<const int64_t*>(seg_base),
      static_cast<const int64_t*>(seg_len), n_seg, g, L,
      static_cast<const int64_t*>(sf), static_cast<const int64_t*>(off),
      static_cast<const int*>(bucket), n_tiles, w.ctl, w.runs, w.run_start);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaMemcpyAsync(count, w.ctl + kCtlCands,
                                          sizeof(long long),
                                          cudaMemcpyDeviceToHost, st));
}

// After the sync, the n candidates of the run table in ws, sorted by the
// key segment << rid_bits | read id of ``bits`` bits: ``route`` 0 the
// one-block kernel (n <= kBlockMax, bits <= 32; no scratch), 1 the
// radix route (scratch of gaml_candgen_scratch_bytes).  rids int64
// [CSR]; seed2 int64 [rows, 2]; row_of int64; out int64 [5, ld], ld = n
// rounded up to 8 (rows 64-byte aligned): rid, g0, r0, orient, seg in
// each row's first n.
extern "C" int gaml_candgen_sort(void* ws, int n_tiles, const void* rids,
                                 const void* seed2, const void* row_of,
                                 int n, int rid_bits, int bits, int route,
                                 void* scratch, void* out, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Workspace w(ws, n_tiles);
  int64_t* o = static_cast<int64_t*>(out);
  const size_t ld = (static_cast<size_t>(n) + 7) & ~static_cast<size_t>(7);
  int64_t* const outs[5] = {o, o + ld, o + 2 * ld, o + 3 * ld, o + 4 * ld};
  const int64_t* r = static_cast<const int64_t*>(rids);
  const int64_t* s2 = static_cast<const int64_t*>(seed2);
  const int64_t* ro = static_cast<const int64_t*>(row_of);
  if (n < 1 || bits < 0 || bits > 63 || rid_bits < 0 || rid_bits > 32)
    return static_cast<int>(cudaErrorInvalidValue);
  if (route == 0) {
    if (n > kBlockMax || bits > 32)
      return static_cast<int>(cudaErrorInvalidValue);
    static int set[kDevices] = {};
    const int aerr = smem_attr(candgen_block_kernel, block_smem(kBlockMax),
                               set);
    if (aerr) return aerr;
    candgen_block_kernel<<<1, kBlockThreads, block_smem(n), st>>>(
        w.ctl, w.runs, w.run_start, r, n, rid_bits, n_passes(bits), s2, ro,
        outs[0], outs[1], outs[2], outs[3], outs[4]);
    return static_cast<int>(cudaGetLastError());
  }
  const Scratch sc(scratch, n, bits > 32 ? 8 : 4);
  return bits > 32 ? radix<unsigned long long>(w, r, s2, ro, n, rid_bits, bits,
                                               sc, outs, st)
                   : radix<uint32_t>(w, r, s2, ro, n, rid_bits, bits, sc,
                                     outs, st);
}
