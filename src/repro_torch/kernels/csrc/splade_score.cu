// Kernel 3: SPLADE stage-1 impact scoring over pid-sorted posting rows,
// with a per-block top-k as a second entry point.
//
// Replaces the TPU kernel `splade_block_pallas_batch`
// (src/repro/kernels/splade_score/splade_score.py:97) and, as a B=1
// launch, `splade_block_pallas` (same file, :71); the top-k entry point
// also takes over the `lax.top_k` that follows it on the JAX path.
//
// row_pids (R, max_df) i32, each row sorted by pid read as unsigned (so
// -1 pads sit at its end); row_imps (R, max_df) u8 or f32 in the same
// order; rows (B, Qt) i32: the posting row that query b's term slot t
// reads (-1: an empty slot); w (B, Qt) f32: that slot's weight, already
// scaled by the index's quantum. The function is
//
//     scores[b, p] = sum of w[b, t] * imp over the entries (t, j) with
//                    rows[b, t] >= 0, w[b, t] > 0, row_pids[...] == p,
//
// added in (term slot ascending, posting slot ascending) order from
// +0.0. That is the order of the host CSR scorer
// (SpladeIndex.score_batch_host, one query-major np.add.at), so with
// untruncated postings a row of this kernel equals the host's bit for
// bit, and which candidate reaches the 200th place of stage 1 does not
// depend on the backend (quantised impacts tie often). A stable sort by
// pid keeps each doc's entries of one row in their posting order, so
// the sorted copy adds each doc's entries in the order of the unsorted
// layout.
//
// The FMA trap: nvcc contracts a*b + c into one fused multiply-add by
// default, which rounds once where the host rounds twice. The product
// and the sum are therefore written with __fmul_rn and __fadd_rn,
// which the compiler never contracts.
//
// Design. One block owns one query row b and a block of kBlockD docs
// [lo, hi). Each warp binary-searches two of the query's rows at once
// for [lo, hi) (32 lanes probe each bound, so a row of 1,024 takes two
// dependent loads); the hits of up to 32 term slots are staged into
// shared memory in (term slot, posting slot) order. Each doc slot
// belongs to one thread (slot mod kThreads), and only that thread adds
// into it, in list order: each warp ballots the staged entries of its
// own slots, 32 at a time, and walks them four at a step (an owner lane
// adds its entries of a step in their order). No two threads add into
// one score, and no float atomics are used (integer atomics count
// histograms, mark slots and count finished blocks). A block's cost
// follows its hits, not the padded row length, so the doc block can be
// small enough to fill the card at B=1.
//
// - splade_score_launch writes the whole (B, n_docs) row, zeros
//   included, in blocks of kScoreBlockD = 2048 docs (49 blocks a query
//   at 100,000 docs).
// - splade_topk_launch gives the top-k of each row in one launch, in
//   blocks of kTopkBlockD = 8192 docs (13 sets of candidates a query to
//   merge at 100,000 docs). Each block takes its kb = min(k, docs in
//   block) docs of rank < kb by (score desc, pid asc) and writes them in
//   pid order ((-inf, -1) past kb) to the row's candidates: a radix
//   select of the kb-th key over the order-keeping bits of the fp32
//   scores (8 bits a pass, integer histograms in shared memory), then
//   every doc above that key and the lowest-pid docs at it. The passes visit only the slots that were
//   added into (a bitmap marked in the walk); every other slot holds
//   +0.0 and is counted at once, so a pass costs the block's hits, not
//   its slots. The row's last block to finish (a counter per row) merges
//   its candidates, which lie in pid order: a radix select of the k-th
//   key, an ordered compaction of the k winners, and a stable LSD radix
//   sort of those by key, so ties stay in pid order, as lax.top_k keeps
//   them. With k >= n_docs every block keeps all its docs and the merge
//   sorts the whole row.
//
// Bound on the H100: bytes. Scores: the real postings of the queried
// rows read once plus 4*B*n_docs bytes written. Top-k: the same postings
// plus 8*B*k bytes of (pid, score) written; the per-block candidates
// are the launch's own intermediate, not the function's output. There
// is ~1 FLOP per 5 bytes read.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kGroup = 32;     // term slots searched and staged together
constexpr int kList = 1024;    // staged hits per window
constexpr int kUnroll = 4;     // candidate loads in flight per thread

template <int kThreads, int kBlockD>
struct Shared {
  union {
    float acc[kBlockD];        // the block's scores
    struct {                   // the merge's (acc is done by then)
      unsigned short cnt[kThreads / 32][256];  // a chunk's digits by warp
      unsigned hist4[4][256];  // the winners' four 8-bit digits
    };
  };
  unsigned touched[kBlockD / 32];  // bit s: slot s was added into
  int list_slot[kList];
  float list_val[kList];
  int g_row[kGroup];
  int g_start[kGroup];
  int g_cnt[kGroup];
  int g_off[kGroup];
  float g_w[kGroup];
  int g_total;
  unsigned hist[256];
  int bin_base[256];
  int warp_sums[kThreads / 32];
  int sel[3];                  // digit, count above it, count at it
  int is_last;
};

// For two rows at once (the warp's two term slots): out[2r], out[2r+1]
// = the first and the last+1 entry of row r[0, len_r) whose pid lies in
// [lo, hi), for rows sorted by pid read as unsigned (so negative pids
// sort last and never fall in the range). Every lane of the warp calls
// it and gets the answer. Each pass probes 32 evenly spaced entries of
// the open range of each of the four bounds, so rows of up to 1,024
// entries take two dependent loads.
__device__ __forceinline__ void range_warp2(const int32_t* __restrict__ row0,
                                            int len0,
                                            const int32_t* __restrict__ row1,
                                            int len1, unsigned lo,
                                            unsigned hi, int lane,
                                            int out[4]) {
  const int32_t* row[2] = {row0, row1};
  const unsigned key[4] = {lo, hi, lo, hi};
  int a[4] = {0, 0, 0, 0};                 // each bound lies in [a, a + n]
  int n[4] = {len0, len0, len1, len1};
  while (n[0] > 32 || n[1] > 32 || n[2] > 32 || n[3] > 32) {
    int st[4];
    bool v[4];
    unsigned x[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {          // the loads first, then the votes
      st[q] = (n[q] + 31) / 32;
      const int pos = a[q] + (lane + 1) * st[q] - 1;
      v[q] = n[q] > 32 && pos < a[q] + n[q];
      x[q] = v[q] ? static_cast<unsigned>(__ldg(row[q / 2] + pos)) : 0u;
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int c = __popc(__ballot_sync(kFull, v[q] && x[q] < key[q]));
      if (n[q] > 32) {
        const int a2 = a[q] + c * st[q];
        n[q] = min(st[q] - 1, a[q] + n[q] - a2);
        a[q] = a2;
      }
    }
  }
  bool l[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    l[q] = lane < n[q] &&
           static_cast<unsigned>(__ldg(row[q / 2] + a[q] + lane)) < key[q];
  }
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    out[q] = a[q] + __popc(__ballot_sync(kFull, l[q]));
  }
}

// Scores of query b over docs [lo, hi) into sh.acc[0, hi - lo); slots
// past hi - lo stay 0. With kMark, sh.touched gets the slots that were
// added into. Ends with a barrier, so every thread may then read every
// slot.
template <bool kMark, typename Imp, int kThreads, int kBlockD>
__device__ void score_block(Shared<kThreads, kBlockD>& sh,
                            const int32_t* __restrict__ row_pids,
                            const Imp* __restrict__ row_imps,
                            const int32_t* __restrict__ rows_b,
                            const float* __restrict__ w_b, int Qt,
                            int max_df, int lo, int hi) {
  constexpr int kWarps = kThreads / 32;
  static_assert(kGroup % (2 * kWarps) == 0, "two term slots per warp");
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;

  // the barriers below order these stores before the owners' adds
  for (int s = tid; s < kBlockD; s += kThreads) sh.acc[s] = 0.f;
  if (kMark) {
    for (int i = tid; i < kBlockD / 32; i += kThreads) sh.touched[i] = 0u;
  }

  for (int g0 = 0; g0 < Qt; g0 += kGroup) {
    if (tid < kGroup) {               // the group's slots, loaded at once
      const int t = g0 + tid;
      sh.g_row[tid] = t < Qt ? rows_b[t] : -1;
      sh.g_w[tid] = t < Qt ? w_b[t] : 0.f;
    }
    __syncthreads();
    // each warp searches two term slots at once, tl and tl + kWarps
    for (int tl = warp; tl < kGroup; tl += 2 * kWarps) {
      int len[2];
      const int32_t* r[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = sh.g_row[tl + h * kWarps];
        const bool live = row >= 0 && sh.g_w[tl + h * kWarps] > 0.f;
        len[h] = live ? max_df : 0;
        r[h] = row_pids + (live ? static_cast<size_t>(row) * max_df : 0);
      }
      int bounds[4];
      range_warp2(r[0], len[0], r[1], len[1], static_cast<unsigned>(lo),
                  static_cast<unsigned>(hi), lane, bounds);
      if (lane < 2) {
        const int t = tl + lane * kWarps;
        sh.g_start[t] = bounds[2 * lane];
        sh.g_cnt[t] = bounds[2 * lane + 1] - bounds[2 * lane];
      }
    }
    __syncthreads();
    if (warp == 0) {                  // exclusive offsets of the hits
      const int c = sh.g_cnt[lane];
      int incl = c;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int u = __shfl_up_sync(kFull, incl, o);
        if (lane >= o) incl += u;
      }
      sh.g_off[lane] = incl - c;
      if (lane == 31) sh.g_total = incl;
    }
    __syncthreads();
    const int total = sh.g_total;
    for (int base = 0; base < total; base += kList) {
      const int n = min(kList, total - base);
      for (int i = tid; i < n; i += kThreads) {
        const int e = base + i;
        int tl = 0;                   // the last slot whose offset <= e
#pragma unroll
        for (int step = kGroup / 2; step > 0; step >>= 1) {
          if (sh.g_off[tl + step] <= e) tl += step;
        }
        const size_t at = static_cast<size_t>(sh.g_row[tl]) * max_df +
                          sh.g_start[tl] + (e - sh.g_off[tl]);
        sh.list_slot[i] = __ldg(row_pids + at) - lo;
        sh.list_val[i] =
            __fmul_rn(sh.g_w[tl], static_cast<float>(__ldg(row_imps + at)));
      }
      __syncthreads();
      // slot s belongs to thread s mod kThreads: warp (s / 32) mod
      // kWarps, lane s mod 32. Each warp reads the list 32 entries at a
      // time and walks its own entries in list order.
      for (int c = 0; c < n; c += 32) {
        const int i = c + lane;
        int s = 0;
        float v = 0.f;
        if (i < n) {
          s = sh.list_slot[i];
          v = sh.list_val[i];
        }
        unsigned own =
            __ballot_sync(kFull, i < n && (s >> 5) % kWarps == warp);
        while (own) {                 // four entries a step, in order
          int ss[4];
          float vv[4];
          bool ok[4];
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            ok[u] = own != 0;
            const int src = ok[u] ? __ffs(own) - 1 : 0;
            own &= own - 1;
            ss[u] = __shfl_sync(kFull, s, src);
            vv[u] = __shfl_sync(kFull, v, src);
          }
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            if (ok[u] && (ss[u] & 31) == lane) {
              sh.acc[ss[u]] = __fadd_rn(sh.acc[ss[u]], vv[u]);
              // lanes of this warp share the word: an integer atomic
              if (kMark) atomicOr(&sh.touched[ss[u] >> 5], 1u << lane);
            }
          }
        }
      }
      __syncthreads();                // the list is rewritten next
    }
  }
  __syncthreads();
}

// Exclusive prefix over the warps of a value uniform in each warp;
// *total gets the sum.
template <int kThreads>
__device__ __forceinline__ int warps_exclusive(int v, int* warp_sums,
                                               int* total) {
  constexpr int kWarps = kThreads / 32;
  const int warp = threadIdx.x / 32;
  if (threadIdx.x % 32 == 0) warp_sums[warp] = v;
  __syncthreads();
  int before = 0, sum = 0;
#pragma unroll
  for (int i = 0; i < kWarps; ++i) {
    const int x = warp_sums[i];
    before += i < warp ? x : 0;
    sum += x;
  }
  *total = sum;
  __syncthreads();               // warp_sums is rewritten next
  return before;
}

template <typename Imp, int kThreads, int kBlockD>
__global__ void __launch_bounds__(kThreads)
splade_score_kernel(const int32_t* __restrict__ row_pids,
                    const Imp* __restrict__ row_imps,
                    const int32_t* __restrict__ rows,
                    const float* __restrict__ w, float* __restrict__ out,
                    int Qt, int max_df, int n_docs) {
  __shared__ Shared<kThreads, kBlockD> sh;
  const int b = blockIdx.y;
  const int lo = blockIdx.x * kBlockD;
  const int hi = min(lo + kBlockD, n_docs);
  score_block<false, Imp, kThreads, kBlockD>(
      sh, row_pids, row_imps, rows + static_cast<size_t>(b) * Qt,
      w + static_cast<size_t>(b) * Qt, Qt, max_df, lo, hi);
  float* out_b = out + static_cast<size_t>(b) * n_docs + lo;
  for (int s = threadIdx.x; s < hi - lo; s += kThreads) out_b[s] = sh.acc[s];
}

// fp32 bits -> unsigned keys in the order of the values, and back
__device__ __forceinline__ unsigned order_key(float f) {
  const unsigned u = __float_as_uint(f);
  return u ^ ((u >> 31) ? kFull : 0x80000000u);
}

__device__ __forceinline__ float key_value(unsigned k) {
  return __uint_as_float(k ^ ((k >> 31) ? 0x80000000u : kFull));
}

// One radix-select step, by warp 0 over sh.hist: the digit holding the
// need-th largest key (digits taken from 255 down), the count above it
// and the count at it, into sh.sel.
template <int kThreads, int kBlockD>
__device__ __forceinline__ void pick_digit(Shared<kThreads, kBlockD>& sh,
                                           int need, int lane) {
  int cnt[8], sum = 0;          // lane l holds digits 255-8l .. 248-8l
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    cnt[r] = static_cast<int>(sh.hist[255 - 8 * lane - r]);
    sum += cnt[r];
  }
  int incl = sum;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int u = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += u;
  }
  int above = incl - sum;
  if (above < need && need <= incl) {
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      if (above + cnt[r] >= need) {
        sh.sel[0] = 255 - 8 * lane - r;
        sh.sel[1] = above;
        sh.sel[2] = cnt[r];
        break;
      }
      above += cnt[r];
    }
  }
}

// hist[digit] += 1 for every lane whose digit is >= 0; the lanes that
// share lane 0's digit add in one atomic (one digit often dominates).
__device__ __forceinline__ void hist_add(unsigned* hist, int digit,
                                         int lane) {
  const int d0 = __shfl_sync(kFull, digit, 0);
  const unsigned same = __ballot_sync(kFull, digit == d0);
  if (digit >= 0 && (digit != d0 || lane == 0)) {
    atomicAdd(&hist[digit], digit == d0 ? __popc(same) : 1u);
  }
}

// The top-k of one query row from its blocks' candidates cs/cp[0, n)
// (blocks in pid order, each in pid order): a radix select of the k-th
// key over the candidates, an ordered compaction of the k winners into
// (sa_k, sa_p) with their keys inverted, and a stable LSD radix sort of
// those by key (8 bits a pass, ping-pong with sb_*; the four digit
// histograms taken in one sweep), so ties stay in pid order. Writes
// out_p/out_s[0, k) by (score desc, pid asc). Candidates are read
// through L2 (__ldcg): other blocks wrote them.
template <int kThreads, int kBlockD>
__device__ void merge_row(Shared<kThreads, kBlockD>& sh,
                          const float* cs, const int32_t* cp, int n, int k,
                          unsigned* sa_k, int32_t* sa_p, unsigned* sb_k,
                          int32_t* sb_p, int32_t* __restrict__ out_p,
                          float* __restrict__ out_s) {
  constexpr int kWarps = kThreads / 32;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const unsigned below = (1u << lane) - 1u;

  unsigned prefix = 0, pmask = 0;
  int need = k;
  if (k < n) {
    for (int shift = 24; shift >= 0; shift -= 8) {
      for (int i = tid; i < 256; i += kThreads) sh.hist[i] = 0;
      __syncthreads();
      for (int base = 0; base < n; base += kUnroll * kThreads) {
        unsigned kk[kUnroll];         // the loads first, then the counts
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int i = base + u * kThreads + tid;
          kk[u] = i < n ? order_key(__ldcg(cs + i)) : 0u;
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const bool in = base + u * kThreads + tid < n;
          hist_add(sh.hist,
                   in && (kk[u] & pmask) == prefix
                       ? static_cast<int>((kk[u] >> shift) & 0xff) : -1,
                   lane);
        }
      }
      __syncthreads();
      if (warp == 0) pick_digit(sh, need, lane);
      __syncthreads();
      const unsigned d = static_cast<unsigned>(sh.sel[0]);
      need -= sh.sel[1];
      const bool all_taken = sh.sel[2] == need;
      prefix |= d << shift;
      pmask |= 0xffu << shift;
      if (all_taken) break;
    }
  }

  // ordered compaction: warp w owns candidates [w * seg, (w + 1) * seg)
  // and reads them 32 at a time (kUnroll reads in flight), three times:
  // to count its ties, to count its winners, and to write them
  const int seg = (n + kWarps - 1) / kWarps;
  const int c0 = min(n, warp * seg), c1 = min(n, c0 + seg);
  auto keys = [&](int c, unsigned (&kk)[kUnroll]) {
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = c + 32 * u + lane;
      kk[u] = i < c1 ? order_key(__ldcg(cs + i)) : 0u;
    }
  };
  int n_eq = 0;
  for (int c = c0; c < c1; c += 32 * kUnroll) {
    unsigned kk[kUnroll];
    keys(c, kk);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const bool in = c + 32 * u + lane < c1;
      n_eq += __popc(__ballot_sync(kFull, in && (kk[u] & pmask) == prefix));
    }
  }
  int total;
  const int tie0 = warps_exclusive<kThreads>(n_eq, sh.warp_sums, &total);
  // one pass decides (and counts, or writes) the winners in order
  auto winners = [&](int pos, bool write) {
    int tie = tie0;
    for (int c = c0; c < c1; c += 32 * kUnroll) {
      unsigned kk[kUnroll];
      keys(c, kk);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int i = c + 32 * u + lane;
        const unsigned m = kk[u] & pmask;
        const unsigned eqb = __ballot_sync(kFull, i < c1 && m == prefix);
        const bool take = i < c1 && (m > prefix || (m == prefix &&
                                     tie + __popc(eqb & below) < need));
        tie += __popc(eqb);
        const unsigned takeb = __ballot_sync(kFull, take);
        if (write && take) {
          const int at = pos + __popc(takeb & below);
          sa_k[at] = ~kk[u];          // ascending keys: score descending
          sa_p[at] = __ldcg(cp + i);
        }
        pos += __popc(takeb);
      }
    }
    return pos;
  };
  const int pos = warps_exclusive<kThreads>(winners(0, false), sh.warp_sums,
                                            &total);
  for (int i = tid; i < 4 * 256; i += kThreads) {
    sh.hist4[i / 256][i % 256] = 0;
  }
  winners(pos, true);
  __syncthreads();                    // sa and the zeroed hist4

  // the four digit histograms of the winners, in one sweep
  for (int base = 0; base < k; base += kThreads) {
    const int i = base + tid;
    const unsigned key = i < k ? sa_k[i] : 0u;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      hist_add(sh.hist4[q],
               i < k ? static_cast<int>((key >> (8 * q)) & 0xff) : -1, lane);
    }
  }
  for (int i = tid; i < kWarps * 256; i += kThreads) {
    sh.cnt[i / 256][i % 256] = 0;
  }
  __syncthreads();

  unsigned* src_k = sa_k;
  int32_t* src_p = sa_p;
  unsigned* dst_k = sb_k;
  int32_t* dst_p = sb_p;
  for (int q = 0; q < 4; ++q) {
    const int shift = 8 * q;
    if (warp == 0) {                  // exclusive offsets, digits ascending
      int c[8], sum = 0;
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        c[r] = static_cast<int>(sh.hist4[q][8 * lane + r]);
        sum += c[r];
      }
      int incl = sum;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int u = __shfl_up_sync(kFull, incl, o);
        if (lane >= o) incl += u;
      }
      int at = incl - sum;
      bool one_digit = false;
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        sh.bin_base[8 * lane + r] = at;
        at += c[r];
        one_digit |= c[r] == k;
      }
      const unsigned any = __ballot_sync(kFull, one_digit);
      if (lane == 0) sh.sel[0] = any != 0;
    }
    __syncthreads();
    if (sh.sel[0]) {                  // one digit holds every key: no move
      __syncthreads();                // all have read sel before warp 0
      continue;                       // rewrites it and bin_base
    }
    for (int base = 0; base < k; base += kThreads) {
      const int i = base + tid;
      const bool in = i < k;
      const unsigned key = in ? src_k[i] : 0u;
      const int32_t pid = in ? src_p[i] : 0;
      const int d = (key >> shift) & 0xff;
      unsigned peers = __ballot_sync(kFull, in);
#pragma unroll
      for (int bit = 0; bit < 8; ++bit) {
        const unsigned v = __ballot_sync(kFull, (d >> bit) & 1);
        peers &= ((d >> bit) & 1) ? v : ~v;
      }
      const int rank = __popc(peers & below);
      if (in && rank == 0) sh.cnt[warp][d] = __popc(peers);
      __syncthreads();
      if (in) {
        int at = sh.bin_base[d] + rank;
        for (int w2 = 0; w2 < warp; ++w2) at += sh.cnt[w2][d];
        dst_k[at] = key;
        dst_p[at] = pid;
      }
      __syncthreads();
      if (tid < 256) {
        int sum = 0;
        for (int w2 = 0; w2 < kWarps; ++w2) {
          sum += sh.cnt[w2][tid];
          sh.cnt[w2][tid] = 0;
        }
        sh.bin_base[tid] += sum;
      }
      __syncthreads();
    }
    unsigned* tk = src_k;
    src_k = dst_k;
    dst_k = tk;
    int32_t* tp = src_p;
    src_p = dst_p;
    dst_p = tp;
  }
  for (int i = tid; i < k; i += kThreads) {
    out_p[i] = src_p[i];
    out_s[i] = key_value(~src_k[i]);
  }
}

template <typename Imp, int kThreads, int kBlockD>
__global__ void __launch_bounds__(kThreads)
splade_topk_kernel(const int32_t* __restrict__ row_pids,
                   const Imp* __restrict__ row_imps,
                   const int32_t* __restrict__ rows,
                   const float* __restrict__ w, float* cand_scores,
                   int32_t* cand_pids, unsigned* scratch, int* counters,
                   int32_t* __restrict__ out_pids,
                   float* __restrict__ out_scores, int Qt, int max_df,
                   int n_docs, int k) {
  constexpr int kRounds = kBlockD / kThreads;  // 32-slot rounds a warp emits
  constexpr unsigned kZeroKey = 0x80000000u;   // order_key(+0.0f)
  __shared__ Shared<kThreads, kBlockD> sh;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const unsigned below = (1u << lane) - 1u;
  const int b = blockIdx.y;
  const int lo = blockIdx.x * kBlockD;
  const int hi = min(lo + kBlockD, n_docs);
  const int n_in = hi - lo;
  score_block<true, Imp, kThreads, kBlockD>(
      sh, row_pids, row_imps, rows + static_cast<size_t>(b) * Qt,
      w + static_cast<size_t>(b) * Qt, Qt, max_df, lo, hi);

  // radix select of the kb-th largest key: after the passes, the docs
  // whose masked key is above `prefix` are all taken, and `need` more
  // come from those equal to it, lowest pid first. Only the touched
  // slots are visited; the others all hold +0.0, and are counted at
  // once.
  const int n_words = (n_in + 31) / 32;
  int n_touched;
  warps_exclusive<kThreads>(
      __reduce_add_sync(kFull, tid < n_words ? __popc(sh.touched[tid]) : 0),
      sh.warp_sums, &n_touched);
  const unsigned n_untouched = static_cast<unsigned>(n_in - n_touched);
  const int kb = min(k, n_in);
  unsigned prefix = 0, pmask = 0;
  int need = kb;
  if (kb < n_in) {
    for (int shift = 24; shift >= 0; shift -= 8) {
      for (int i = tid; i < 256; i += kThreads) sh.hist[i] = 0;
      __syncthreads();
      if (tid < n_words) {
        for (unsigned m = sh.touched[tid]; m; m &= m - 1) {
          const unsigned kk = order_key(sh.acc[tid * 32 + __ffs(m) - 1]);
          if ((kk & pmask) == prefix) {
            atomicAdd(&sh.hist[(kk >> shift) & 0xff], 1u);
          }
        }
      }
      if (tid == 0 && n_untouched && (kZeroKey & pmask) == prefix) {
        atomicAdd(&sh.hist[(kZeroKey >> shift) & 0xff], n_untouched);
      }
      __syncthreads();
      if (warp == 0) pick_digit(sh, need, lane);
      __syncthreads();
      const unsigned d = static_cast<unsigned>(sh.sel[0]);
      need -= sh.sel[1];
      const bool all_taken = sh.sel[2] == need;
      prefix |= d << shift;
      pmask |= 0xffu << shift;
      if (all_taken) break;   // uniform: every thread read the same sel
    }
  }

  // ordered emission: warp w owns slots [w * kRounds * 32, ...) and
  // reads them 32 at a time; a doc is taken when its masked key is
  // above the prefix, or at it with fewer than `need` such docs of
  // lower pid before it
  const int c0 = warp * kRounds * 32;
  unsigned gt[kRounds], eq[kRounds];
  int n_eq = 0;
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    const int s = c0 + r * 32 + lane;
    const bool in = s < n_in;
    const unsigned m = in ? order_key(sh.acc[s]) & pmask : 0u;
    gt[r] = __ballot_sync(kFull, in && m > prefix);
    eq[r] = __ballot_sync(kFull, in && m == prefix);
    n_eq += __popc(eq[r]);
  }
  int total;
  int tie = warps_exclusive<kThreads>(n_eq, sh.warp_sums, &total);
  int n_sel = 0;
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {   // eq[r] becomes the taken ties
    const bool tied =
        (eq[r] >> lane & 1u) && tie + __popc(eq[r] & below) < need;
    tie += __popc(eq[r]);
    eq[r] = gt[r] | __ballot_sync(kFull, tied);
    n_sel += __popc(eq[r]);
  }
  int pos = warps_exclusive<kThreads>(n_sel, sh.warp_sums, &total);
  const int kb_max = min(k, kBlockD);
  const int n_cand = gridDim.x * kb_max;
  float* cs = cand_scores + static_cast<size_t>(b) * n_cand;
  int32_t* cp = cand_pids + static_cast<size_t>(b) * n_cand;
  const int out0 = blockIdx.x * kb_max;
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    if (eq[r] >> lane & 1u) {
      const int s = c0 + r * 32 + lane;
      const int at = out0 + pos + __popc(eq[r] & below);
      cs[at] = sh.acc[s];
      cp[at] = lo + s;
    }
    pos += __popc(eq[r]);
  }
  for (int i = kb + tid; i < kb_max; i += kThreads) {
    cs[out0 + i] = -__int_as_float(0x7f800000);
    cp[out0 + i] = -1;
  }

  // the row's last block to finish merges the row's candidates
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    sh.is_last = atomicAdd(counters + b, 1) == static_cast<int>(gridDim.x) - 1;
  }
  __syncthreads();
  if (!sh.is_last) return;
  __threadfence();
  unsigned* sa = scratch + static_cast<size_t>(b) * 4 * k;
  merge_row(sh, cs, cp, n_cand, k, sa, reinterpret_cast<int32_t*>(sa + k),
            sa + 2 * k, reinterpret_cast<int32_t*>(sa + 3 * k),
            out_pids + static_cast<size_t>(b) * k,
            out_scores + static_cast<size_t>(b) * k);
}

struct Args {
  const void* row_pids;
  const void* row_imps;
  bool imps_u8;
  const void* rows;
  const void* w;
  void* out;           // scores mode: (B, n_docs) f32
  void* cand_scores;   // top-k mode: (B, n_cand) f32
  void* cand_pids;     // (B, n_cand) i32
  void* scratch;       // (B, 4, k) u32
  void* counters;      // (B,) i32, zero
  void* out_pids;      // (B, k) i32
  void* out_scores;    // (B, k) f32
  int B, Qt, max_df, n_docs, k;
};

template <typename Imp, int kThreads, int kBlockD>
void launch_typed(bool topk, const Args& x, cudaStream_t st) {
  const dim3 grid((x.n_docs + kBlockD - 1) / kBlockD, x.B);
  const int32_t* pids = static_cast<const int32_t*>(x.row_pids);
  const Imp* imps = static_cast<const Imp*>(x.row_imps);
  const int32_t* rows = static_cast<const int32_t*>(x.rows);
  const float* w = static_cast<const float*>(x.w);
  if (topk) {
    splade_topk_kernel<Imp, kThreads, kBlockD><<<grid, kThreads, 0, st>>>(
        pids, imps, rows, w, static_cast<float*>(x.cand_scores),
        static_cast<int32_t*>(x.cand_pids),
        static_cast<unsigned*>(x.scratch), static_cast<int*>(x.counters),
        static_cast<int32_t*>(x.out_pids), static_cast<float*>(x.out_scores),
        x.Qt, x.max_df, x.n_docs, x.k);
  } else {
    splade_score_kernel<Imp, kThreads, kBlockD><<<grid, kThreads, 0, st>>>(
        pids, imps, rows, w, static_cast<float*>(x.out), x.Qt, x.max_df,
        x.n_docs);
  }
}

template <int kThreads, int kBlockD>
void launch(bool topk, const Args& x, cudaStream_t st) {
  static_assert(kBlockD % kThreads == 0 && kBlockD / 32 <= kThreads,
                "one thread per 32-slot word of the touched map");
  if (x.imps_u8) {
    launch_typed<uint8_t, kThreads, kBlockD>(topk, x, st);
  } else {
    launch_typed<float, kThreads, kBlockD>(topk, x, st);
  }
}

// The doc-block sizes: small score blocks fill the card at B=1; large
// top-k blocks keep the candidates to merge few (13 * k per query at
// 100,000 docs). ops.py mirrors them (SCORE_BLOCK_DOCS, TOPK_BLOCK_DOCS).
constexpr int kScoreThreads = 256, kScoreBlockD = 2048;
constexpr int kTopkThreads = 512, kTopkBlockD = 8192;

int dispatch(bool topk, const Args& x, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (topk) {
    launch<kTopkThreads, kTopkBlockD>(true, x, st);
  } else {
    launch<kScoreThreads, kScoreBlockD>(false, x, st);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Both launch on `stream` and return cudaGetLastError() (0 on success).
// imps_u8 selects the impact type: 1 for u8 (quantised), 0 for f32.
extern "C" int splade_score_launch(const void* row_pids, const void* row_imps,
                                   int imps_u8, const void* rows,
                                   const void* w, void* out, int B, int Qt,
                                   int max_df, int n_docs, void* stream) {
  Args x{};
  x.row_pids = row_pids;
  x.row_imps = row_imps;
  x.imps_u8 = imps_u8 != 0;
  x.rows = rows;
  x.w = w;
  x.out = out;
  x.B = B;
  x.Qt = Qt;
  x.max_df = max_df;
  x.n_docs = n_docs;
  return dispatch(false, x, stream);
}

// Top-k mode, 1 <= k <= n_docs. cand_scores/cand_pids (B, n_blocks ·
// min(k, kTopkBlockD)), n_blocks = ceil(n_docs / kTopkBlockD): each block's
// candidates; scratch (B, 4k) u32; counters (B,) i32, all 0 at launch;
// out_pids/out_scores (B, k): the top-k by (score desc, pid asc).
extern "C" int splade_topk_launch(const void* row_pids, const void* row_imps,
                                  int imps_u8, const void* rows,
                                  const void* w, void* cand_scores,
                                  void* cand_pids, void* scratch,
                                  void* counters, void* out_pids,
                                  void* out_scores, int B, int Qt,
                                  int max_df, int n_docs, int k,
                                  void* stream) {
  Args x{};
  x.row_pids = row_pids;
  x.row_imps = row_imps;
  x.imps_u8 = imps_u8 != 0;
  x.rows = rows;
  x.w = w;
  x.cand_scores = cand_scores;
  x.cand_pids = cand_pids;
  x.scratch = scratch;
  x.counters = counters;
  x.out_pids = out_pids;
  x.out_scores = out_scores;
  x.B = B;
  x.Qt = Qt;
  x.max_df = max_df;
  x.n_docs = n_docs;
  x.k = k;
  return dispatch(true, x, stream);
}
