// Native host kernels for gaml_tpu.
//
// C ABI, built with plain g++ (see build.py), loaded via ctypes.  Three
// groups:
//  - maxhash_window_query: the sliding-window max-hash genome query
//    (semantics of reference GetMinHashWithPoses, graph.cc:1289-1323);
//  - process_hit_batch: the exact 0-1 BFS seed extension
//    (reference ProcessHit, graph.cc:753-837) over a candidate batch —
//    the bit-parity "bfs" backend's fast path;
//  - reach_limit_compute / reach_big_compute: the per-node Dijkstra/BFS
//    reachability precomputes (reference graph.cc:108-198).
//
// All outputs are bit-identical to the Python implementations (tested in
// tests/test_native.py).

#define _USE_MATH_DEFINES
#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <cstdio>
#include <cstdlib>
#include <deque>
#include <map>
#include <queue>
#include <set>
#include <vector>

extern "C" {

// ---------------------------------------------------------------- maxhash
// seq: 2-bit-coded bases (0..3; >=4 hashes as 0). Emits collapsed
// (hash, kmer_end_pos) pairs for read_len-wide windows. Returns count
// (clipped to cap).
int64_t maxhash_window_query(const uint8_t* seq, int64_t n, int32_t read_len,
                             uint64_t* out_hash, int32_t* out_pos,
                             int64_t cap) {
  const int K = 15;
  const uint64_t XOR = 0x2204abcdULL;
  const uint64_t MASK = (1ULL << (2 * K)) - 1;
  if (n < K || n < read_len) return 0;
  int64_t count = 0;
  std::deque<std::pair<uint64_t, int64_t>> d;
  uint64_t cur = 0;
  for (int64_t i = 0; i < K; i++) {
    cur = (cur << 2) | (seq[i] < 4 ? seq[i] : 0);
  }
  uint64_t mh = cur ^ XOR;
  d.push_back({mh, K - 1});
  uint64_t last_mh = 0;
  bool have_last = false;
  for (int64_t i = K; i < n; i++) {
    while (!d.empty() && d.front().second < i - read_len + K) d.pop_front();
    cur = ((cur << 2) & MASK) | (seq[i] < 4 ? seq[i] : 0);
    uint64_t h = cur ^ XOR;
    while (!d.empty() && d.back().first < h) d.pop_back();
    d.push_back({h, i});
    if (i >= read_len - 1) {
      uint64_t mhx = d.front().first;
      if (i == read_len - 1 || !have_last || mhx != last_mh) {
        if (count < cap) {
          out_hash[count] = mhx;
          out_pos[count] = (int32_t)d.front().second;
        }
        count++;
        last_mh = mhx;
        have_last = true;
      }
    }
  }
  return count < cap ? count : cap;
}

// ------------------------------------------------------------- ProcessHit
// Exact reference 0-1 BFS (graph.cc:753-837), including the push-marked
// visited set and its search-order artifacts.  Returns via out arrays:
// errs = -1 on failure; begin as in the reference (may be -1 for
// genome-start seeds).
struct QItem {
  int64_t g;
  int32_t r;
};

// The reference's single deque holds a LIFO run of cost-c items at the
// front (push_front on match) followed by a FIFO run of cost-(c+1) items
// at the back (push_back on error).  That is exactly a per-level stack
// whose bottom is the previous level's FIFO overflow reversed — so we run
// it as two preallocated vectors (cur = stack popped from the back, nxt =
// FIFO accumulated in order, promoted reversed), which reproduces the
// reference pop order bit-for-bit without deque allocation churn.
static void process_hit_one(const uint8_t* genome, int64_t glen,
                            const uint8_t* read, int32_t rlen, int32_t g0,
                            int32_t r0, int32_t* out_errs,
                            int32_t* out_begin,
                            std::vector<int32_t>& visited, int32_t& stamp,
                            int32_t vdim) {
  const int K = 15;
  const int ERROR_LIMIT = 3;
  auto vis = [&](int32_t r, int64_t g) -> int32_t& {
    int64_t gp = g - g0 + r0 + 20;
    return visited[(int64_t)(r + 1) * vdim + gp];
  };
  auto gch = [&](int64_t g) -> int {
    return (g >= 0 && g < glen) ? genome[g] : -1;
  };
  *out_errs = -1;
  *out_begin = -1;

  int forward_errs = -1;
  // zero-error fast path: a cost-0 search path can only be the clean
  // match diagonal (match edges are the sole cost-0 transitions and the
  // visited set cannot block a single chain), so scan it directly.
  {
    int64_t g = g0 + K;
    int32_t r = r0 + K;
    while (r < rlen && g < glen && genome[g] == read[r]) {
      g++;
      r++;
    }
    if (r == rlen) forward_errs = 0;
  }

  static thread_local std::vector<QItem> cur, nxt;
  if (forward_errs == -1) {
    stamp++;
    cur.clear();
    nxt.clear();
    cur.push_back({g0 + K, r0 + K});
    int cost = 0;
    bool done = false;
    while (!done) {
      while (!cur.empty()) {
        QItem x = cur.back();
        cur.pop_back();
        int64_t g = x.g;
        int32_t r = x.r;
        if (r == rlen) {
          forward_errs = cost;
          done = true;
          break;
        }
        if (gch(g) == read[r]) {
          if (g + 1 < glen || r + 1 == rlen) {
            if (vis(r + 1, g + 1) != stamp) {
              vis(r + 1, g + 1) = stamp;
              cur.push_back({g + 1, r + 1});
            }
          }
        } else {
          if (g + 1 < glen) {
            if (vis(r + 1, g + 1) != stamp) {
              vis(r + 1, g + 1) = stamp;
              nxt.push_back({g + 1, r + 1});
            }
            if (vis(r, g + 1) != stamp) {
              vis(r, g + 1) = stamp;
              nxt.push_back({g + 1, r});
            }
          }
          if (vis(r + 1, g) != stamp) {
            vis(r + 1, g) = stamp;
            nxt.push_back({g, r + 1});
          }
        }
      }
      if (done) break;
      cost++;
      if (cost > ERROR_LIMIT || nxt.empty()) break;
      cur.assign(nxt.rbegin(), nxt.rend());
      nxt.clear();
    }
  }
  if (forward_errs == -1) return;

  int backward_errs = -1;
  int64_t begin_pos = -1;
  if (g0 == 0) {
    if (r0 < 6) backward_errs = r0;
  } else {
    // zero-error backward diagonal fast path (same argument as forward)
    {
      int64_t g = g0 - 1;
      int32_t r = r0 - 1;
      while (r > -1 && g >= 0 && genome[g] == read[r]) {
        g--;
        r--;
      }
      if (r == -1) {
        backward_errs = 0;
        begin_pos = g + 1;
      }
    }
    if (backward_errs == -1) {
      stamp++;
      cur.clear();
      nxt.clear();
      cur.push_back({g0 - 1, r0 - 1});
      int cost = 0;
      bool done = false;
      while (!done) {
        while (!cur.empty()) {
          QItem x = cur.back();
          cur.pop_back();
          int64_t g = x.g;
          int32_t r = x.r;
          if (r == -1) {
            backward_errs = cost;
            begin_pos = g + 1;
            done = true;
            break;
          }
          if (gch(g) == read[r]) {
            if (g - 1 >= 0 || r - 1 == -1) {
              if (vis(r - 1, g - 1) != stamp) {
                vis(r - 1, g - 1) = stamp;
                cur.push_back({g - 1, r - 1});
              }
            }
          } else {
            if (g - 1 >= 0) {
              if (vis(r - 1, g - 1) != stamp) {
                vis(r - 1, g - 1) = stamp;
                nxt.push_back({g - 1, r - 1});
              }
              if (vis(r, g - 1) != stamp) {
                vis(r, g - 1) = stamp;
                nxt.push_back({g - 1, r});
              }
            }
            if (vis(r - 1, g) != stamp) {
              vis(r - 1, g) = stamp;
              nxt.push_back({g, r - 1});
            }
          }
        }
        if (done) break;
        cost++;
        if (cost > ERROR_LIMIT || nxt.empty()) break;
        cur.assign(nxt.rbegin(), nxt.rend());
        nxt.clear();
      }
    }
  }
  if (backward_errs == -1) return;
  *out_errs = forward_errs + backward_errs;
  *out_begin = (int32_t)begin_pos;
}

void process_hit_batch(const uint8_t* genome, int64_t glen,
                       const uint8_t* reads, const int64_t* read_offsets,
                       const int32_t* rlens, const int32_t* g0s,
                       const int32_t* r0s, int64_t n, int32_t* out_errs,
                       int32_t* out_begin) {
  int32_t max_rlen = 0;
  for (int64_t i = 0; i < n; i++)
    if (rlens[i] > max_rlen) max_rlen = rlens[i];
  int32_t vdim = max_rlen + 47;
  std::vector<int32_t> visited((int64_t)(max_rlen + 47) * vdim, 0);
  int32_t stamp = 0;
  for (int64_t i = 0; i < n; i++) {
    process_hit_one(genome, glen, reads + read_offsets[i], rlens[i], g0s[i],
                    r0s[i], out_errs + i, out_begin + i, visited, stamp,
                    vdim);
  }
}

// ------------------------------------------------------- window aligner
// The whole AlignSubpathInternal (reference graph.cc:839-899) in one call:
// max-hash window query on both strands, candidate expansion through the
// fingerprint index, precomputed seed positions, the exact 0-1 BFS
// extension, and the first-wins (position, read) dedup with sorted output.
struct WinAl {
  int32_t ed, orient;
};

// Candidate collection shared by the full window aligner and the
// extension-free query used by the device backend: max-hash window query
// on both strands + fingerprint lookup.  Fills (rid, signed seed pos)
// stable-sorted by rid — this reproduces the reference rid-ascending map
// iteration with per-rid insertion order (fwd hits first, then rc).
static void collect_window_cands(
    const uint8_t* seq, int64_t glen, int32_t read_len,
    const uint64_t* fp_sorted, const int64_t* fp_off, const int32_t* fp_rids,
    int64_t n_fp, std::vector<std::pair<int32_t, int64_t>>& cands) {
  static thread_local std::vector<int32_t> pos_buf;
  static thread_local std::vector<uint64_t> hash_buf;
  if ((int64_t)pos_buf.size() < glen) {
    pos_buf.resize(glen);
    hash_buf.resize(glen);
  }
  int64_t n_fwd = maxhash_window_query(seq, glen, read_len, hash_buf.data(),
                                       pos_buf.data(), glen);
  auto lookup = [&](uint64_t mh, int64_t signed_pos) {
    int64_t lo = 0, hi = n_fp;
    while (lo < hi) {
      int64_t mid = (lo + hi) / 2;
      if (fp_sorted[mid] < mh)
        lo = mid + 1;
      else
        hi = mid;
    }
    if (lo < n_fp && fp_sorted[lo] == mh) {
      for (int64_t k = fp_off[lo]; k < fp_off[lo + 1]; k++) {
        cands.push_back({fp_rids[k], signed_pos});
      }
    }
  };
  for (int64_t i = 0; i < n_fwd; i++) lookup(hash_buf[i], pos_buf[i]);
  static thread_local std::vector<uint8_t> rcseq;
  if ((int64_t)rcseq.size() < glen) rcseq.resize(glen);
  for (int64_t i = 0; i < glen; i++) {
    uint8_t c = seq[glen - 1 - i];
    rcseq[i] = c < 4 ? (uint8_t)(3 - c) : c;
  }
  int64_t n_rc = maxhash_window_query(rcseq.data(), glen, read_len,
                                      hash_buf.data(), pos_buf.data(), glen);
  for (int64_t i = 0; i < n_rc; i++) lookup(hash_buf[i], -(int64_t)pos_buf[i]);
  std::stable_sort(cands.begin(), cands.end(),
                   [](const std::pair<int32_t, int64_t>& a,
                      const std::pair<int32_t, int64_t>& b) {
                     return a.first < b.first;
                   });
}

static int64_t align_window_impl(
    const uint8_t* seq, int64_t glen, int32_t read_len, int32_t offset,
    const uint64_t* fp_sorted, const int64_t* fp_off, const int32_t* fp_rids,
    int64_t n_fp,
    const uint8_t* codes_fwd, const uint8_t* codes_rc, int64_t stride,
    const int32_t* seed_pos,  // [R, 2] row-major (fwd, rc)
    const int32_t* row_of,    // rid -> row index in the matrices
    int32_t* out_pos, int32_t* out_ed, int32_t* out_rid, int32_t* out_or,
    int64_t cap) {
  const int K = 15;
  if (glen < read_len || read_len == 0) return 0;
  static thread_local std::vector<std::pair<int32_t, int64_t>> cands;
  cands.clear();
  collect_window_cands(seq, glen, read_len, fp_sorted, fp_off, fp_rids, n_fp,
                       cands);

  // extension per candidate, dedup first-wins by (position, rid)
  int32_t max_rlen = read_len;
  int32_t vdim = max_rlen + 47;
  static thread_local std::vector<int32_t> visited;
  static thread_local int32_t stamp = 0;
  if ((int64_t)visited.size() < (int64_t)(max_rlen + 47) * vdim ||
      stamp > 2000000000) {
    visited.assign((int64_t)(max_rlen + 47) * vdim, 0);
    stamp = 0;
  }
  struct Found {
    int32_t pos, rid, ed, orient;
  };
  static thread_local std::vector<Found> found;
  found.clear();
  for (size_t ci = 0; ci < cands.size(); ci++) {
    int32_t rid = cands[ci].first;
    int64_t e2 = cands[ci].second;
    int32_t row = row_of[rid];
    int64_t g0;
    const uint8_t* read;
    int32_t orient, r0;
    if (e2 > 0) {
      g0 = e2 - K + 1;
      read = codes_fwd + (int64_t)row * stride;
      orient = 0;
      r0 = seed_pos[2 * row];
    } else {
      g0 = glen + e2 - 1;
      read = codes_rc + (int64_t)row * stride;
      orient = 1;
      r0 = seed_pos[2 * row + 1];
    }
    int32_t errs, begin;
    process_hit_one(seq, glen, read, read_len, (int32_t)g0, r0, &errs,
                    &begin, visited, stamp, vdim);
    if (errs < 0) continue;
    found.push_back({begin + 1 + offset, rid, errs, orient});
  }
  // stable sort by (pos, rid): equal keys keep emission order, so the
  // first in each run is the reference's first-wins map emplace
  std::stable_sort(found.begin(), found.end(),
                   [](const Found& a, const Found& b) {
                     return a.pos != b.pos ? a.pos < b.pos : a.rid < b.rid;
                   });
  int64_t n = 0;
  for (size_t i = 0; i < found.size(); i++) {
    if (i > 0 && found[i].pos == found[i - 1].pos &&
        found[i].rid == found[i - 1].rid)
      continue;  // first-wins dedup
    if (n < cap) {
      out_pos[n] = found[i].pos;
      out_rid[n] = found[i].rid;
      out_ed[n] = found[i].ed;
      out_or[n] = found[i].orient;
    }
    n++;
  }
  return n;  // may exceed cap: caller retries with a larger buffer
}

int64_t align_window(
    const uint8_t* seq, int64_t glen, int32_t read_len, int32_t offset,
    const uint64_t* fp_sorted, const int64_t* fp_off, const int32_t* fp_rids,
    int64_t n_fp,
    const uint8_t* codes_fwd, const uint8_t* codes_rc, int64_t stride,
    const int32_t* seed_pos, const int32_t* row_of,
    int32_t* out_pos, int32_t* out_ed, int32_t* out_rid, int32_t* out_or,
    int64_t cap) {
  return align_window_impl(seq, glen, read_len, offset, fp_sorted, fp_off,
                           fp_rids, n_fp, codes_fwd, codes_rc, stride,
                           seed_pos, row_of, out_pos, out_ed, out_rid,
                           out_or, cap);
}

// Many windows in one call, parallel across OS threads (windows are
// independent; every output slice is private, so results are
// bit-identical to the serial loop).  out_off gives each window's slice
// [out_off[i], out_off[i+1]); out_ns[i] may exceed the slice (caller
// retries that window singly with a bigger buffer).
void align_windows_batch(
    const uint8_t* seq_buf, const int64_t* seq_off, const int64_t* seq_len,
    const int32_t* offsets, int32_t n_win, int32_t read_len,
    const uint64_t* fp_sorted, const int64_t* fp_off, const int32_t* fp_rids,
    int64_t n_fp, const uint8_t* codes_fwd, const uint8_t* codes_rc,
    int64_t stride, const int32_t* seed_pos, const int32_t* row_of,
    const int64_t* out_off, int32_t* out_pos, int32_t* out_ed,
    int32_t* out_rid, int32_t* out_or, int64_t* out_ns) {
#pragma omp parallel for schedule(dynamic)
  for (int32_t i = 0; i < n_win; i++) {
    int64_t cap = out_off[i + 1] - out_off[i];
    out_ns[i] = align_window_impl(
        seq_buf + seq_off[i], seq_len[i], read_len, offsets[i], fp_sorted,
        fp_off, fp_rids, n_fp, codes_fwd, codes_rc, stride, seed_pos, row_of,
        out_pos + out_off[i], out_ed + out_off[i], out_rid + out_off[i],
        out_or + out_off[i], cap);
  }
}

// Extension-free candidate query for one window: emits per-candidate
// (rid, g0, r0, orient) for the device extend kernel (the device
// backend's host side — candidate semantics identical to the bfs
// backend's, reference graph.cc:858-884).  Returns count (may exceed
// cap; caller retries with a bigger buffer).
static int64_t query_window_impl(
    const uint8_t* seq, int64_t glen, int32_t read_len,
    const uint64_t* fp_sorted, const int64_t* fp_off, const int32_t* fp_rids,
    int64_t n_fp, const int32_t* seed_pos, const int32_t* row_of,
    int32_t* out_rid, int32_t* out_g0, int32_t* out_r0, int32_t* out_or,
    int64_t cap) {
  const int K = 15;
  if (glen < read_len || read_len == 0) return 0;
  static thread_local std::vector<std::pair<int32_t, int64_t>> cands;
  cands.clear();
  collect_window_cands(seq, glen, read_len, fp_sorted, fp_off, fp_rids, n_fp,
                       cands);
  int64_t n = (int64_t)cands.size();
  int64_t m = n < cap ? n : cap;
  for (int64_t i = 0; i < m; i++) {
    int32_t rid = cands[i].first;
    int64_t e2 = cands[i].second;
    int32_t row = row_of[rid];
    out_rid[i] = rid;
    if (e2 > 0) {
      out_g0[i] = (int32_t)(e2 - K + 1);
      out_r0[i] = seed_pos[2 * row];
      out_or[i] = 0;
    } else {
      out_g0[i] = (int32_t)(glen + e2 - 1);
      out_r0[i] = seed_pos[2 * row + 1];
      out_or[i] = 1;
    }
  }
  return n;
}

int64_t query_window(
    const uint8_t* seq, int64_t glen, int32_t read_len,
    const uint64_t* fp_sorted, const int64_t* fp_off, const int32_t* fp_rids,
    int64_t n_fp, const int32_t* seed_pos, const int32_t* row_of,
    int32_t* out_rid, int32_t* out_g0, int32_t* out_r0, int32_t* out_or,
    int64_t cap) {
  return query_window_impl(seq, glen, read_len, fp_sorted, fp_off, fp_rids,
                           n_fp, seed_pos, row_of, out_rid, out_g0, out_r0,
                           out_or, cap);
}

// Many windows' candidate queries in one call, OpenMP-parallel (windows
// independent, private output slices).
void query_windows_batch(
    const uint8_t* seq_buf, const int64_t* seq_off, const int64_t* seq_len,
    int32_t n_win, int32_t read_len,
    const uint64_t* fp_sorted, const int64_t* fp_off, const int32_t* fp_rids,
    int64_t n_fp, const int32_t* seed_pos, const int32_t* row_of,
    const int64_t* out_off, int32_t* out_rid, int32_t* out_g0,
    int32_t* out_r0, int32_t* out_or, int64_t* out_ns) {
#pragma omp parallel for schedule(dynamic)
  for (int32_t i = 0; i < n_win; i++) {
    int64_t cap = out_off[i + 1] - out_off[i];
    out_ns[i] = query_window_impl(
        seq_buf + seq_off[i], seq_len[i], read_len, fp_sorted, fp_off,
        fp_rids, n_fp, seed_pos, row_of, out_rid + out_off[i],
        out_g0 + out_off[i], out_r0 + out_off[i], out_or + out_off[i], cap);
  }
}

// Paired coverage-gap sweep (reference graph.cc:2092-2119 ==
// graph.cc:1893-1919): sort events by (pos, type) and scan.
int64_t coverage_sweep(const int32_t* ev_pos, const int32_t* ev_typ,
                       int64_t n, double exp_cov_move, double span_limit) {
  static thread_local std::vector<std::pair<int32_t, int32_t>> ev;
  ev.resize(n);
  for (int64_t i = 0; i < n; i++) ev[i] = {ev_pos[i], ev_typ[i]};
  if (n > 8192) {
    // stable LSD radix by (typ, pos-low16, pos-high16) == sort by
    // (pos, typ); pos sign handled by biasing the high half
    static thread_local std::vector<std::pair<int32_t, int32_t>> tmp;
    tmp.resize(n);
    static thread_local std::vector<int64_t> cnt;
    cnt.assign(65536, 0);
    for (int64_t i = 0; i < n; i++) cnt[ev[i].second & 0xffff]++;
    for (int32_t d = 1; d < 65536; d++) cnt[d] += cnt[d - 1];
    for (int64_t i = n - 1; i >= 0; i--)
      tmp[--cnt[ev[i].second & 0xffff]] = ev[i];
    cnt.assign(65536, 0);
    for (int64_t i = 0; i < n; i++) cnt[tmp[i].first & 0xffff]++;
    for (int32_t d = 1; d < 65536; d++) cnt[d] += cnt[d - 1];
    for (int64_t i = n - 1; i >= 0; i--)
      ev[--cnt[tmp[i].first & 0xffff]] = tmp[i];
    cnt.assign(65536, 0);
    for (int64_t i = 0; i < n; i++)
      cnt[((uint32_t)(ev[i].first ^ 0x80000000)) >> 16]++;
    for (int32_t d = 1; d < 65536; d++) cnt[d] += cnt[d - 1];
    for (int64_t i = n - 1; i >= 0; i--)
      tmp[--cnt[((uint32_t)(ev[i].first ^ 0x80000000)) >> 16]] = ev[i];
    ev.swap(tmp);
  } else
    std::sort(ev.begin(), ev.end());
  int64_t last_event_pos = 0;
  int32_t last_event_type = -1;
  int64_t last_begin = 0;
  int64_t bad_bases = 0;
  for (int64_t i = 0; i < n; i++) {
    int64_t pos = ev[i].first;
    int32_t typ = ev[i].second;
    if (typ == 3) {
      if ((double)(pos - last_event_pos) > exp_cov_move &&
          (last_event_type == 3 || last_event_type < 0) &&
          (double)(pos - last_begin) > span_limit) {
        bad_bases += pos - last_event_pos;
      }
    }
    if (typ == 1) last_begin = pos;
    last_event_pos = pos;
    last_event_type = typ;
  }
  return bad_bases;
}

// ------------------------------------------------ position collection
// GetPositionsOnlyPath's per-alignment work (reference graph.cc:535-598)
// over a window stream covering a whole walk: offset positions by each
// window's cur_pos, apply the trailing-duplicate filter
// (pos < max_pos - 5 skip; max_pos advances per path-index group, resets
// per contig), dedup per read by exact position (replace), and emit the
// final per-read lists grouped by ascending read id.
struct PosEntry {
  int32_t pos, ed, orient;
};

int64_t collect_positions(
    int32_t n_windows, const int64_t* w_off, const int32_t* w_len,
    const int32_t* w_curpos, const int32_t* w_group, const int32_t* w_ctg,
    const int32_t* a_pos, const int32_t* a_ed, const int32_t* a_rid,
    const int32_t* a_or, int32_t use_filter,
    int32_t* out_rid, int64_t* out_start, int32_t* out_cnt,
    int32_t* out_pos, int32_t* out_ed, int32_t* out_or,
    int32_t* out_nreads) {
  if (n_windows == 0) {
    *out_nreads = 0;
    return 0;
  }
  // per-rid insertion-ordered lists as a pooled linked list over
  // stamp-validated head/tail arrays (no per-call map/vector churn);
  // output is grouped by ascending rid like the old std::map walk
  int64_t flat_n = w_off[n_windows - 1] + w_len[n_windows - 1];
  int32_t max_rid = 0;
  for (int64_t i = 0; i < flat_n; i++)
    if (a_rid[i] > max_rid) max_rid = a_rid[i];
  static thread_local std::vector<int32_t> head, tail_, rstamp;
  static thread_local int32_t stamp = 0;
  if ((int64_t)head.size() < (int64_t)max_rid + 1) {
    head.resize(max_rid + 1);
    tail_.resize(max_rid + 1);
    rstamp.assign(max_rid + 1, 0);
    stamp = 0;
  }
  stamp++;
  if (stamp == 0x7fffffff) {
    std::fill(rstamp.begin(), rstamp.end(), 0);
    stamp = 1;
  }
  struct PE {
    int32_t pos, ed, orient, next;
  };
  static thread_local std::vector<PE> pool;
  static thread_local std::vector<int32_t> rids_seen;
  pool.clear();
  rids_seen.clear();

  int32_t max_pos = 0;
  int32_t cur_max_pos = 0;
  int32_t last_group = -1;
  int32_t last_ctg = -1;
  for (int32_t w = 0; w < n_windows; w++) {
    if (w_ctg[w] != last_ctg) {
      max_pos = 0;
      cur_max_pos = 0;
      last_ctg = w_ctg[w];
      last_group = w_group[w];
    } else if (w_group[w] != last_group) {
      max_pos = max_pos > cur_max_pos ? max_pos : cur_max_pos;
      cur_max_pos = 0;
      last_group = w_group[w];
    }
    int32_t curpos = w_curpos[w];
    for (int32_t k = 0; k < w_len[w]; k++) {
      int64_t idx = w_off[w] + k;
      int32_t pos = a_pos[idx] + curpos;
      if (use_filter && pos < max_pos - 5) continue;
      if (pos > cur_max_pos) cur_max_pos = pos;
      int32_t rid = a_rid[idx];
      if (rstamp[rid] != stamp) {
        rstamp[rid] = stamp;
        head[rid] = tail_[rid] = -1;
        rids_seen.push_back(rid);
      }
      bool found = false;
      for (int32_t it = head[rid]; it != -1; it = pool[it].next) {
        if (pool[it].pos == pos) {
          pool[it].ed = a_ed[idx];
          pool[it].orient = a_or[idx];
          found = true;
          break;
        }
      }
      if (!found) {
        pool.push_back({pos, a_ed[idx], a_or[idx], -1});
        int32_t ni = (int32_t)pool.size() - 1;
        if (tail_[rid] == -1)
          head[rid] = ni;
        else
          pool[tail_[rid]].next = ni;
        tail_[rid] = ni;
      }
    }
  }
  std::sort(rids_seen.begin(), rids_seen.end());
  int32_t nr = 0;
  int64_t total = 0;
  for (int32_t rid : rids_seen) {
    out_rid[nr] = rid;
    out_start[nr] = total;
    int32_t cnt = 0;
    for (int32_t it = head[rid]; it != -1; it = pool[it].next) {
      out_pos[total] = pool[it].pos;
      out_ed[total] = pool[it].ed;
      out_or[total] = pool[it].orient;
      total++;
      cnt++;
    }
    out_cnt[nr] = cnt;
    nr++;
  }
  *out_nreads = nr;
  return total;
}

// Pointer-per-window variant of collect_positions: the window column
// arrays stay wherever the alignment cache holds them (no megabase
// flat-buffer concatenation on the Python side — the staging cost that
// dominated per-move rescores of long walks).  Semantics are identical
// to collect_positions; w_pos/w_ed/w_rid/w_or are arrays of raw int32*
// addresses, one per window.
int64_t collect_positions_ptr(
    int32_t n_windows, const int64_t* w_pos, const int64_t* w_ed,
    const int64_t* w_rid, const int64_t* w_or, const int32_t* w_len,
    const int32_t* w_curpos, const int32_t* w_group, const int32_t* w_ctg,
    int32_t use_filter, int32_t n_reads_hint,
    int32_t* out_rid, int64_t* out_start, int32_t* out_cnt,
    int32_t* out_pos, int32_t* out_ed, int32_t* out_or,
    int32_t* out_nreads) {
  if (n_windows == 0) {
    *out_nreads = 0;
    return 0;
  }
  (void)n_reads_hint;
  // pass A (streaming): apply the trailing-duplicate filter in window
  // order, emitting kept entries as packed structs
  struct CE {
    int32_t pos, rid;
    int16_t ed, orient;
  };
  static thread_local std::vector<CE> kept, tmp;
  kept.clear();
  {
    int32_t max_pos = 0;
    int32_t cur_max_pos = 0;
    int32_t last_group = -1;
    int32_t last_ctg = -1;
    for (int32_t w = 0; w < n_windows; w++) {
      if (w_ctg[w] != last_ctg) {
        max_pos = 0;
        cur_max_pos = 0;
        last_ctg = w_ctg[w];
        last_group = w_group[w];
      } else if (w_group[w] != last_group) {
        max_pos = max_pos > cur_max_pos ? max_pos : cur_max_pos;
        cur_max_pos = 0;
        last_group = w_group[w];
      }
      int32_t curpos = w_curpos[w];
      const int32_t* c_pos = (const int32_t*)w_pos[w];
      const int32_t* c_ed = (const int32_t*)w_ed[w];
      const int32_t* c_rid = (const int32_t*)w_rid[w];
      const int32_t* c_or = (const int32_t*)w_or[w];
      for (int32_t k = 0; k < w_len[w]; k++) {
        int32_t pos = c_pos[k] + curpos;
        if (use_filter && pos < max_pos - 5) continue;
        if (pos > cur_max_pos) cur_max_pos = pos;
        kept.push_back({pos, c_rid[k], (int16_t)c_ed[k], (int16_t)c_or[k]});
      }
    }
  }
  int64_t K = (int64_t)kept.size();
  // pass B: stable LSD radix by rid (16-bit x 2) — sequential bucket
  // writes instead of per-entry pointer chasing over read-count-sized
  // scratch arrays
  static thread_local std::vector<int64_t> cnt;
  tmp.resize(K);
  cnt.assign(65536, 0);
  for (int64_t i = 0; i < K; i++) cnt[kept[i].rid & 0xffff]++;
  for (int32_t d = 1; d < 65536; d++) cnt[d] += cnt[d - 1];
  for (int64_t i = K - 1; i >= 0; i--)
    tmp[--cnt[kept[i].rid & 0xffff]] = kept[i];
  cnt.assign(65536, 0);
  for (int64_t i = 0; i < K; i++) cnt[(uint32_t)tmp[i].rid >> 16]++;
  for (int32_t d = 1; d < 65536; d++) cnt[d] += cnt[d - 1];
  for (int64_t i = K - 1; i >= 0; i--)
    kept[--cnt[(uint32_t)tmp[i].rid >> 16]] = tmp[i];
  // pass C: contiguous rid runs in original emission order (stable
  // radix); dedup by position = first-occurrence order, last-written
  // ed/orient — identical to the reference map-emplace + overwrite
  int32_t nr = 0;
  int64_t total = 0;
  int64_t i = 0;
  while (i < K) {
    int32_t rid = kept[i].rid;
    int64_t run_start = total;
    out_rid[nr] = rid;
    out_start[nr] = total;
    for (; i < K && kept[i].rid == rid; i++) {
      int32_t pos = kept[i].pos;
      bool found = false;
      for (int64_t j = run_start; j < total; j++) {
        if (out_pos[j] == pos) {
          out_ed[j] = kept[i].ed;
          out_or[j] = kept[i].orient;
          found = true;
          break;
        }
      }
      if (!found) {
        out_pos[total] = pos;
        out_ed[total] = kept[i].ed;
        out_or[total] = kept[i].orient;
        total++;
      }
    }
    out_cnt[nr] = (int32_t)(total - run_start);
    nr++;
  }
  *out_nreads = nr;
  return total;
}

// Two-sided pair loop: intersect both mates' grouped position lists by
// read id (two-pointer over ascending rids) and run the innie pair
// products + events (reference graph.cc:1853-1892).
int64_t paired_inc_pairs2(
    const int32_t* rid1, const int64_t* st1, const int32_t* cnt1, int32_t n1,
    const int32_t* pos1, const int32_t* ed1, const int32_t* or1,
    const int32_t* rid2, const int64_t* st2, const int32_t* cnt2, int32_t n2,
    const int32_t* pos2, const int32_t* ed2, const int32_t* or2,
    const int32_t* rlen1_all, const int32_t* rlen2_all,
    const double* match_pow1, const double* mismatch_pow1,
    const double* match_pow2, const double* mismatch_pow2,
    const double* ins_table, int64_t ins_n, double ins_mean, double ins_std,
    double min_prob_start, double min_prob_per_base, int32_t use_all_to_cov,
    double* out_p, int32_t* out_rid,
    int32_t* out_ev_pos, int32_t* out_ev_typ, int64_t* out_ev_cnt) {
  int64_t np = 0;
  int64_t ne = 0;
  const double denom = sqrt(2.0 * M_PI) * ins_std;
  int32_t i = 0, j = 0;
  while (i < n1 && j < n2) {
    if (rid1[i] < rid2[j]) { i++; continue; }
    if (rid2[j] < rid1[i]) { j++; continue; }
    int32_t rid = rid1[i];
    int32_t L1 = rlen1_all[rid];
    int32_t L2 = rlen2_all[rid];
    double threshold = exp(min_prob_start + min_prob_per_base * (L2 + L2));
    const int32_t* xp = pos1 + st1[i];
    const int32_t* xe = ed1 + st1[i];
    const int32_t* xo = or1 + st1[i];
    const int32_t* yp = pos2 + st2[j];
    const int32_t* ye = ed2 + st2[j];
    const int32_t* yo = or2 + st2[j];
    for (int32_t a = 0; a < cnt1[i]; a++) {
      double p1v = mismatch_pow1[xe[a]] * match_pow1[L1 - xe[a]];
      for (int32_t b = 0; b < cnt2[j]; b++) {
        if (xo[a] == yo[b]) continue;
        int64_t dist;
        if (xp[a] < yp[b]) {
          if (xo[a] != 0 || yo[b] != 1) continue;
          dist = (int64_t)yp[b] - xp[a] + L2;
        } else {
          if (xo[a] != 1 || yo[b] != 0) continue;
          dist = (int64_t)xp[a] - yp[b] + L1;
        }
        double p2v = mismatch_pow2[ye[b]] * match_pow2[L2 - ye[b]];
        double insprob;
        if (dist >= 0 && dist < ins_n) {
          insprob = ins_table[dist];
        } else {
          double z = ((double)dist - ins_mean) / ins_std;
          insprob = exp(-z * z / 2.0) / denom;
        }
        double p = p1v * p2v * insprob;
        if (p > threshold) {
          out_ev_pos[ne] = xp[a] > yp[b] ? xp[a] : yp[b];
          out_ev_typ[ne] = 3;
          ne++;
          if (use_all_to_cov) {
            out_ev_pos[ne] = xp[a] < yp[b] ? xp[a] : yp[b];
            out_ev_typ[ne] = 3;
            ne++;
          }
        }
        out_p[np] = p;
        out_rid[np] = rid;
        np++;
      }
    }
    i++;
    j++;
  }
  *out_ev_cnt = ne;
  return np;
}

// ------------------------------------------------------- paired pair loop
// The incremental paired scorer's hot inner loop (reference
// CalcScoreForPathInc pair products, graph.cc:1853-1892): for each read,
// all (pos1, pos2) combos in innie geometry emit p1*p2*insert_pdf(dist)
// in x-major order, plus coverage events for pairs above the threshold.
// Sequential float64 arithmetic in the same order as the Python loop —
// bit-identical, C speed.
int64_t paired_inc_pairs(
    const int32_t* rids, int32_t n_rids,
    const int64_t* p1_start, const int32_t* p1_cnt,
    const int32_t* pos1, const int32_t* ed1, const int32_t* or1,
    const int64_t* p2_start, const int32_t* p2_cnt,
    const int32_t* pos2, const int32_t* ed2, const int32_t* or2,
    const int32_t* rlen1, const int32_t* rlen2,
    const double* match_pow1, const double* mismatch_pow1,
    const double* match_pow2, const double* mismatch_pow2,
    const double* ins_table, int64_t ins_n, double ins_mean, double ins_std,
    double min_prob_start, double min_prob_per_base, int32_t use_all_to_cov,
    double* out_p, int32_t* out_rid,
    int32_t* out_ev_pos, int32_t* out_ev_typ, int64_t* out_ev_cnt) {
  int64_t np = 0;
  int64_t ne = 0;
  const double two_pi_c = sqrt(2.0 * M_PI) * ins_std;
  for (int32_t ri = 0; ri < n_rids; ri++) {
    int32_t rid = rids[ri];
    // quirk: threshold uses read_set2's length twice (graph.cc:1855-1857)
    double threshold =
        exp(min_prob_start + min_prob_per_base * (rlen2[ri] + rlen2[ri]));
    const int32_t* xp = pos1 + p1_start[ri];
    const int32_t* xe = ed1 + p1_start[ri];
    const int32_t* xo = or1 + p1_start[ri];
    const int32_t* yp = pos2 + p2_start[ri];
    const int32_t* ye = ed2 + p2_start[ri];
    const int32_t* yo = or2 + p2_start[ri];
    for (int32_t i = 0; i < p1_cnt[ri]; i++) {
      double p1v = mismatch_pow1[xe[i]] * match_pow1[rlen1[ri] - xe[i]];
      for (int32_t j = 0; j < p2_cnt[ri]; j++) {
        if (xo[i] == yo[j]) continue;
        int64_t dist;
        if (xp[i] < yp[j]) {
          if (xo[i] != 0 || yo[j] != 1) continue;
          dist = (int64_t)yp[j] - xp[i] + rlen2[ri];
        } else {
          if (xo[i] != 1 || yo[j] != 0) continue;
          dist = (int64_t)xp[i] - yp[j] + rlen1[ri];
        }
        double p2v = mismatch_pow2[ye[j]] * match_pow2[rlen2[ri] - ye[j]];
        double insprob;
        if (dist >= 0 && dist < ins_n) {
          insprob = ins_table[dist];
        } else {
          double z = ((double)dist - ins_mean) / ins_std;
          insprob = exp(-z * z / 2.0) / two_pi_c;
        }
        double p = p1v * p2v * insprob;
        if (p > threshold) {
          out_ev_pos[ne] = xp[i] > yp[j] ? xp[i] : yp[j];
          out_ev_typ[ne] = 3;
          ne++;
          if (use_all_to_cov) {
            out_ev_pos[ne] = xp[i] < yp[j] ? xp[i] : yp[j];
            out_ev_typ[ne] = 3;
            ne++;
          }
        }
        out_p[np] = p;
        out_rid[np] = rid;
        np++;
      }
    }
  }
  *out_ev_cnt = ne;
  return np;
}

// -------------------------------------------------------------- fastq IO
// Fast 4-line FASTQ parsing with 2-bit-table encoding (the reference's
// getline loops, graph.cc:1366-1441, are the setup hot spot in Python).
struct FastqData {
  std::vector<uint8_t> codes;       // concatenated encoded reads
  std::vector<int64_t> read_off;    // n+1 offsets
  std::vector<char> names;          // concatenated names (no separators)
  std::vector<int64_t> name_off;    // n+1 offsets
};

void* fastq_parse(const char* path) {
  FILE* f = fopen(path, "rb");
  if (!f) return nullptr;
  FastqData* d = new FastqData();
  d->read_off.push_back(0);
  d->name_off.push_back(0);
  uint8_t lut[256];
  for (int i = 0; i < 256; i++) lut[i] = 4;
  lut['G'] = 0;
  lut['A'] = 1;
  lut['T'] = 2;
  lut['C'] = 3;
  char* line = nullptr;
  size_t cap = 0;
  ssize_t len;
  int phase = 0;
  while ((len = getline(&line, &cap, f)) >= 0) {
    while (len > 0 && (line[len - 1] == '\n' || line[len - 1] == '\r')) len--;
    if (phase == 0) {
      // name: first whitespace token after '@'
      ssize_t s = len > 0 ? 1 : 0;
      ssize_t e = s;
      while (e < len && line[e] != ' ' && line[e] != '\t') e++;
      d->names.insert(d->names.end(), line + s, line + e);
      d->name_off.push_back((int64_t)d->names.size());
    } else if (phase == 1) {
      for (ssize_t i = 0; i < len; i++)
        d->codes.push_back(lut[(uint8_t)line[i]]);
      d->read_off.push_back((int64_t)d->codes.size());
    }
    phase = (phase + 1) & 3;
  }
  free(line);
  fclose(f);
  return d;
}

int64_t fastq_num_reads(void* h) {
  return (int64_t)((FastqData*)h)->read_off.size() - 1;
}
int64_t fastq_codes_size(void* h) {
  return (int64_t)((FastqData*)h)->codes.size();
}
int64_t fastq_names_size(void* h) {
  return (int64_t)((FastqData*)h)->names.size();
}
void fastq_copy(void* h, uint8_t* codes, int64_t* read_off, char* names,
                int64_t* name_off) {
  FastqData* d = (FastqData*)h;
  std::memcpy(codes, d->codes.data(), d->codes.size());
  std::memcpy(read_off, d->read_off.data(),
              d->read_off.size() * sizeof(int64_t));
  std::memcpy(names, d->names.data(), d->names.size());
  std::memcpy(name_off, d->name_off.data(),
              d->name_off.size() * sizeof(int64_t));
}
void fastq_free(void* h) { delete (FastqData*)h; }

// ----------------------------------------------------------- reachability
struct ReachResult {
  std::vector<int32_t> data;  // records: from, to, len, path...
};

void* reach_limit_compute(int32_t n_nodes, const int32_t* csr_start,
                          const int32_t* csr_idx, const int32_t* node_lens,
                          int32_t max_dist) {
  ReachResult* res = new ReachResult();
  std::vector<int32_t> final_dist(n_nodes), tmp_dist(n_nodes),
      prev(n_nodes);
  for (int32_t i = 0; i < n_nodes; i++) {
    std::priority_queue<std::pair<int32_t, int32_t>,
                        std::vector<std::pair<int32_t, int32_t>>,
                        std::greater<std::pair<int32_t, int32_t>>> fr;
    fr.push({0, i});
    std::fill(final_dist.begin(), final_dist.end(), -1);
    std::fill(tmp_dist.begin(), tmp_dist.end(), 2 * max_dist);
    std::fill(prev.begin(), prev.end(), -1);
    tmp_dist[i] = 0;
    prev[i] = -2;
    while (!fr.empty()) {
      auto [d, x] = fr.top();
      fr.pop();
      if (final_dist[x] != -1) continue;
      final_dist[x] = d;
      int32_t nd = d;
      if (x != i) {
        std::vector<int32_t> pp;
        int32_t cur = prev[x];
        while (cur != i) {
          pp.push_back(cur);
          cur = prev[cur];
        }
        res->data.push_back(i);
        res->data.push_back(x);
        res->data.push_back((int32_t)pp.size());
        for (auto it = pp.rbegin(); it != pp.rend(); ++it)
          res->data.push_back(*it);
        nd += node_lens[x];
      }
      for (int32_t j = csr_start[x]; j < csr_start[x + 1]; j++) {
        int32_t nx = csr_idx[j];
        if (tmp_dist[nx] > nd && nd <= max_dist) {
          tmp_dist[nx] = nd;
          prev[nx] = x;
          fr.push({nd, nx});
        }
      }
    }
  }
  return res;
}

void* reach_big_compute(int32_t n_nodes, const int32_t* csr_start,
                        const int32_t* csr_idx, const int32_t* node_lens,
                        int32_t threshold) {
  ReachResult* res = new ReachResult();
  for (int32_t i = 0; i < n_nodes; i++) {
    if (node_lens[i] <= threshold) continue;
    std::set<int32_t> visited;
    std::map<int32_t, int32_t> prev;
    std::deque<int32_t> fr;
    visited.insert(i);
    fr.push_back(i);
    while (!fr.empty()) {
      int32_t x = fr.front();
      fr.pop_front();
      if (node_lens[x] > threshold && x != i) {
        std::vector<int32_t> pp;
        int32_t cur = prev[x];
        while (cur != i) {
          pp.push_back(cur);
          cur = prev[cur];
        }
        res->data.push_back(i);
        res->data.push_back(x);
        res->data.push_back((int32_t)pp.size());
        for (auto it = pp.rbegin(); it != pp.rend(); ++it)
          res->data.push_back(*it);
        continue;
      }
      for (int32_t j = csr_start[x]; j < csr_start[x + 1]; j++) {
        int32_t ni = csr_idx[j];
        if (visited.count(ni)) continue;
        visited.insert(ni);
        prev[ni] = x;
        fr.push_back(ni);
      }
    }
  }
  return res;
}

int64_t reach_result_size(void* handle) {
  return (int64_t)((ReachResult*)handle)->data.size();
}

void reach_result_copy(void* handle, int32_t* out) {
  ReachResult* res = (ReachResult*)handle;
  std::memcpy(out, res->data.data(), res->data.size() * sizeof(int32_t));
}

void reach_free(void* handle) { delete (ReachResult*)handle; }

// One-pass read-index ingestion over a uniform-length code matrix
// (reference index build, graph.cc:1254-1287, plus the aligner's read-side
// precomputes): per read, the packed k-mers (non-ACGT packs as 0, matching
// the reference trans table), the reverse-complement read's k-mers, the
// max-hash fingerprint, the ACGT flag, and the first fingerprint-k-mer
// position in each orientation.
void read_index_build(const uint8_t* codes, int64_t n, int32_t L, int32_t k,
                      uint64_t* out_fp, uint8_t* out_ok, uint32_t* out_kmers,
                      uint32_t* out_rc, int32_t* out_seed) {
  const int32_t m = L - k + 1;
  if (m <= 0) return;
  const uint32_t XOR = 0x2204abcdu;
  const uint32_t MASK = (uint32_t)((1ull << (2 * k)) - 1);
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < n; i++) {
    const uint8_t* r = codes + i * L;
    uint32_t* km = out_kmers + i * m;
    uint32_t* rc = out_rc + i * m;
    bool ok = true;
    uint32_t cur = 0;
    for (int32_t j = 0; j < L; j++) {
      uint8_t c = r[j];
      if (c >= 4) { ok = false; c = 0; }
      cur = (cur << 2) | c;
      if (j >= k - 1) km[j - k + 1] = cur & MASK;
    }
    out_ok[i] = ok ? 1 : 0;
    uint32_t best = 0;
    int32_t first = 0, last = 0;
    for (int32_t j = 0; j < m; j++) {
      uint32_t h = km[j] ^ XOR;
      if (j == 0 || h > best) { best = h; first = j; last = j; }
      else if (h == best) last = j;
    }
    out_fp[i] = best;
    // rc matrix row: revcomp of km[m-1-j] (complement = XOR full mask,
    // then reverse the 2-bit groups)
    for (int32_t j = 0; j < m; j++) {
      uint32_t v = km[m - 1 - j] ^ MASK;
      uint32_t out = 0;
      for (int32_t b = 0; b < k; b++) {
        out = (out << 2) | (v & 3u);
        v >>= 2;
      }
      rc[j] = out;
    }
    out_seed[2 * i] = first;
    out_seed[2 * i + 1] = m - 1 - last;
  }
}

// k-mer database build for the assembly->graph bootstrap (reference
// KmerDB, graph_from_assembly.cc:86-129, driven by the contig loop at
// graph_from_assembly.cc:150-204).  k-mers (k <= 128) are rolled into
// 2-bit-packed 4x64-bit keys; ids are assigned in first-occurrence order
// with the first-seen orientation EVEN and its reverse complement ODD
// (exactly the reference's db insertion semantics).  Per id the outputs
// carry the spelled base (last base of the even orientation / complement
// of its first base for odd), the end-marker flag, and the "ignored"
// (collapsible interior) flag computed by the reference rule.
struct KmerDbResult {
  std::vector<int32_t> streams;   // concatenated per-contig id streams
  std::vector<uint8_t> char_of;   // per id: spelled base code
  std::vector<uint8_t> ignored;   // per id
  int64_t n_ids = 0;
};

struct K4 {
  uint64_t w[4];
  bool operator==(const K4& o) const {
    return w[0] == o.w[0] && w[1] == o.w[1] && w[2] == o.w[2] &&
           w[3] == o.w[3];
  }
  bool operator<(const K4& o) const {
    for (int i = 3; i >= 0; i--) {
      if (w[i] != o.w[i]) return w[i] < o.w[i];
    }
    return false;
  }
};

static inline uint64_t k4_hash(const K4& k) {
  uint64_t h = 0x9e3779b97f4a7c15ULL;
  for (int i = 0; i < 4; i++) {
    uint64_t x = k.w[i] + h;
    x ^= x >> 30; x *= 0xbf58476d1ce4e5b9ULL;
    x ^= x >> 27; x *= 0x94d049bb133111ebULL;
    x ^= x >> 31;
    h = x + (h << 6) + (h >> 2);
  }
  return h;
}

void* kmer_db_build(const uint8_t* codes, const int64_t* ctg_off,
                    int32_t n_ctgs, int32_t k) {
  auto* res = new KmerDbResult();
  int64_t total = ctg_off[n_ctgs];
  // canonical-key table: entry stores the canonical K4, the base (even)
  // id, and whether the even orientation equals the canonical key
  int64_t max_kmers = total;  // upper bound on distinct k-mers
  int64_t cap = 64;
  while (cap < 2 * max_kmers) cap <<= 1;
  std::vector<int64_t> slots(cap, -1);
  struct Entry { K4 key; int32_t base_id; uint8_t even_is_canon; };
  std::vector<Entry> arena;
  arena.reserve(max_kmers);
  // per-id metadata
  std::vector<uint8_t> char_of;
  std::vector<uint8_t> endm;
  // adjacency summary for the ignored rule: distinct-neighbor count
  // (saturated at 2) and first neighbor
  std::vector<uint8_t> ncnt;
  std::vector<int32_t> nfirst;
  auto grow_id = [&](uint8_t ch_even, uint8_t ch_odd) {
    char_of.push_back(ch_even);
    char_of.push_back(ch_odd);
    endm.push_back(0); endm.push_back(0);
    ncnt.push_back(0); ncnt.push_back(0);
    nfirst.push_back(-1); nfirst.push_back(-1);
  };
  auto add_con_checked = [&](int32_t frm, int32_t to) {
    if (ncnt[frm] == 0) { ncnt[frm] = 1; nfirst[frm] = to; }
    else if (ncnt[frm] == 1 && nfirst[frm] != to) ncnt[frm] = 2;
  };
  const int top_shift = 2 * ((k - 1) & 31);
  const int top_word = (k - 1) >> 5;
  K4 mask{};
  for (int i = 0; i < k; i++) {
    mask.w[i >> 5] |= 3ULL << (2 * (i & 31));
  }
  res->streams.reserve(total);
  for (int32_t ci = 0; ci < n_ctgs; ci++) {
    const uint8_t* c = codes + ctg_off[ci];
    int64_t clen = ctg_off[ci + 1] - ctg_off[ci];
    int64_t n = clen - k + 1;
    if (n <= 0) continue;
    K4 kf{}, kr{};
    int32_t prev = -1;
    for (int64_t i = 0; i < clen; i++) {
      // kf = (kf << 2) | c[i], little-endian across words
      for (int wi = 3; wi > 0; wi--) {
        kf.w[wi] = (kf.w[wi] << 2) | (kf.w[wi - 1] >> 62);
      }
      kf.w[0] = (kf.w[0] << 2) | c[i];
      // kr = (kr >> 2) | comp << (2*(k-1))
      for (int wi = 0; wi < 3; wi++) {
        kr.w[wi] = (kr.w[wi] >> 2) | (kr.w[wi + 1] << 62);
      }
      kr.w[3] >>= 2;
      kr.w[top_word] |= (uint64_t)(3 - c[i]) << top_shift;
      if (i < k - 1) continue;
      for (int wi = 0; wi < 4; wi++) kf.w[wi] &= mask.w[wi];
      const bool fwd_canon = !(kr < kf);
      const K4& canon = fwd_canon ? kf : kr;
      uint64_t h = k4_hash(canon);
      int64_t slot = h & (cap - 1);
      int32_t kid;
      while (true) {
        int64_t e = slots[slot];
        if (e < 0) {
          // new k-mer: even id = this (forward) orientation
          int32_t base = (int32_t)(2 * arena.size());
          slots[slot] = (int64_t)arena.size();
          arena.push_back(Entry{canon, base, (uint8_t)fwd_canon});
          grow_id(c[i], (uint8_t)(3 - c[i - k + 1]));
          kid = base;
          break;
        }
        const Entry& en = arena[e];
        if (en.key == canon) {
          kid = en.base_id +
                ((fwd_canon == (bool)en.even_is_canon) ? 0 : 1);
          break;
        }
        slot = (slot + 1) & (cap - 1);
      }
      int64_t pos = i - k + 1;
      if (prev != -1) {
        add_con_checked(prev, kid);
        add_con_checked(kid ^ 1, prev ^ 1);
      }
      if (pos == 0 || pos == n - 1) {
        endm[kid] = 1;
        endm[kid ^ 1] = 1;
      }
      prev = kid;
      res->streams.push_back(kid);
    }
  }
  res->n_ids = (int64_t)char_of.size();
  res->char_of = std::move(char_of);
  // ignored rule (reference graph_from_assembly.cc:206-222 semantics,
  // mirrored from the python loop): for ascending i with exactly one
  // distinct successor `nxt` and i not an end marker, nxt != i^1, and
  // nxt^1 also single-successor and nxt not an end marker -> ignore nxt
  res->ignored.assign(res->n_ids, 0);
  for (int64_t i = 0; i < res->n_ids; i++) {
    if (ncnt[i] == 1 && !endm[i]) {
      int32_t nxt = nfirst[i];
      if (nxt == (int32_t)(i ^ 1)) continue;
      if (ncnt[nxt ^ 1] == 1 && !endm[nxt]) res->ignored[nxt] = 1;
    }
  }
  return res;
}

int64_t kmer_db_n_ids(void* h) { return ((KmerDbResult*)h)->n_ids; }
int64_t kmer_db_stream_size(void* h) {
  return (int64_t)((KmerDbResult*)h)->streams.size();
}
void kmer_db_copy(void* h, int32_t* streams, uint8_t* char_of,
                  uint8_t* ignored) {
  auto* r = (KmerDbResult*)h;
  std::memcpy(streams, r->streams.data(),
              r->streams.size() * sizeof(int32_t));
  std::memcpy(char_of, r->char_of.data(), r->char_of.size());
  std::memcpy(ignored, r->ignored.data(), r->ignored.size());
}
void kmer_db_free(void* h) { delete (KmerDbResult*)h; }

// Banded log-space forward DP, host variant of ops/forward.py's
// banded_forward (same band semantics: clipped guide steps in {0,1,2},
// fixed-width window, free start, mass at read end).  Small long-read
// batches don't amortize an accelerator dispatch — this runs them on the
// host (double accumulation; agrees with the f32 device kernel to ~1e-5).
static inline double ladd(double a, double b) {
  if (a < b) { double t = a; a = b; b = t; }
  if (b <= -1e29) return a;
  return a + log1p(exp(b - a));
}

void banded_forward_host(const uint8_t* genome, int64_t glen_total,
                         const uint8_t* reads, int64_t rmax,
                         const int32_t* rlens, const int32_t* centers,
                         const int32_t* gstarts, const int32_t* glens,
                         int64_t b, int32_t width, double log_match,
                         double log_mismatch, double* out) {
  const double NEG = -1e30;
#pragma omp parallel for schedule(dynamic)
  for (int64_t i = 0; i < b; i++) {
    int32_t rlen = rlens[i];
    if (rlen <= 0) { out[i] = NEG; continue; }
    const uint8_t* read = reads + i * rmax;
    const int32_t* ctr = centers + i * (rmax + 1);
    int64_t gstart = gstarts[i], gend = (int64_t)gstarts[i] + glens[i];
    std::vector<double> m(width), x(width);
    int64_t base = (int64_t)ctr[0] - width / 2;
    for (int32_t o = 0; o < width; o++) {
      int64_t g = base + o;
      m[o] = (g >= gstart && g < gend) ? 0.0 : NEG;
    }
    auto g_at = [&](int64_t idx) -> int {
      return (idx >= 0 && idx < glen_total) ? genome[idx] : 9;
    };
    for (int32_t j = 1; j <= rlen && j <= rmax; j++) {
      int32_t delta = ctr[j] - ctr[j - 1];
      if (delta < 0) delta = 0;
      if (delta > 2) delta = 2;
      base += delta;
      int rchar = read[j - 1];
      double run = NEG;  // x[o-1]
      for (int32_t o = 0; o < width; o++) {
        int64_t g = base + o;
        bool in_t = (g >= gstart && g < gend);
        int gd = g_at(g - 1);
        double up = (o + delta < width) ? m[o + delta] : NEG;
        double diag = (o + delta - 1 >= 0 && o + delta - 1 < width)
                          ? m[o + delta - 1] : NEG;
        double s_diag = (gd >= 8) ? NEG
                        : (gd == rchar ? log_match : log_mismatch);
        double base_val = in_t ? ladd(diag + s_diag, up + log_mismatch)
                               : NEG;
        double gap_cost = (in_t && gd < 8) ? log_mismatch : NEG;
        run = ladd(base_val, run + gap_cost);
        x[o] = run;
      }
      std::swap(m, x);
    }
    double acc = NEG;
    for (int32_t o = 0; o < width; o++) acc = ladd(acc, m[o]);
    out[i] = acc;
  }
}

// Floored mean-log reduction from cached per-read log probabilities
// (reference GetTotalProb, graph.cc:1495-1516, evaluated in log space):
// score_sum = sum_i max(logp[i] - log2len, logt[i]), zeros = count of
// floored reads.  Four deterministic accumulator lanes (independent of
// thread count / data) so results are reproducible across machines.
double reduce_floored_logs(const double* logp, const double* logt,
                           double log2len, int64_t n, int64_t* out_zeros) {
  double acc[4] = {0.0, 0.0, 0.0, 0.0};
  int64_t zeros = 0;
  int64_t i = 0;
  for (; i + 4 <= n; i += 4) {
    for (int k = 0; k < 4; k++) {
      double a = logp[i + k] - log2len;
      double t = logt[i + k];
      zeros += (a < t);
      acc[k] += a < t ? t : a;
    }
  }
  for (; i < n; i++) {
    double a = logp[i] - log2len;
    double t = logt[i];
    zeros += (a < t);
    acc[0] += a < t ? t : a;
  }
  *out_zeros = zeros;
  return (acc[0] + acc[1]) + (acc[2] + acc[3]);
}

}  // extern "C"
