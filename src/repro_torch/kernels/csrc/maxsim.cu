// Kernel 4: masked MaxSim over uncompressed fp32 doc embeddings.
//
// Replaces the TPU kernel `maxsim_pallas_batch`
// (src/repro/kernels/maxsim/maxsim.py:83) and, as a B=1 launch,
// `maxsim_pallas` (same file, :59).
//
// q (B, Lq, d) f32; docs (B, C, Ld, d) f32; valid (B, C, Ld) u8;
// q_valid (B, Lq) u8  ->  scores (B, C) f32.
//
// Bound on the H100: bytes, barely. Each valid doc token's 4*d bytes are
// read once and meet 2*d FLOPs per real query token: at d=128 and 24
// real query tokens, 12 FLOP per byte, below the ~20 FLOP/byte at which
// the card's fp32 CUDA-core rate (67 TFLOP/s) meets its memory rate
// (3.35 TB/s). So the kernel has to stream the rows at the memory rate
// and keep the FMA pipes near full at the same time.
//
// Arithmetic. Per (query token, doc token) pair it is that of the rerank
// tail (rerank_tile.cuh), so on decoded embeddings the two agree bit for
// bit: one fmaf chain over j = 0 .. d-1, ascending, from 0.f; the max
// over the candidate's valid tokens from kNeg (fmaxf is exact, so any
// split of the tokens gives the same max); score_tile.cuh's `query_sum`.
// No tensor cores (IEEE fp32 is the contract), no split of d across
// lanes, no atomics.
//
// Design.
// - Items. A block scores G candidates of one batch row. A candidate's
//   token positions are cut into chunks of 64, and a chunk with a valid
//   position is an item. Its rows are copied from the 8-row group that
//   holds its first valid position to the one that holds its last (NU
//   groups); rows that are not valid are scored and left out of the max.
//   At the start every warp loads the chunks' valid flags (a batch of
//   chunks' loads in flight at once) into a table of masks in shared
//   memory.
// - Staging: per block, two stages, by TMA. The block's warps form a
//   grid of WQ x WT: warp (wq, wt) takes query tokens 32*wq .. 32*wq+31
//   against column wt's item, so the WQ warps of a column read one
//   staged tile. A stage holds, for each of the WT columns, 32 floats of
//   d (one 128-byte slice) of up to 64 rows; an item passes through d/32
//   stages, its fmaf chains carried in registers from one slice to the
//   next. One producer warp issues 2-D tensor copies
//   (cp.async.bulk.tensor) of 128 bytes per row, one box of 64 rows for
//   an item of 8 groups and one of 8 rows per group for any other (a
//   box costs the copy engine time of its own), completing on the
//   stage's "full" mbarrier, while the consumers score the other stage;
//   they release a stage on its "empty" mbarrier. The copies' 128-byte
//   swizzle spreads the 8 rows a warp reads at once over all banks (the
//   block stores its query rows with the same XOR). The producer hands
//   out the block's items by NU, largest first, WT to a round, so the
//   columns of a round do about the same work.
// - Register tiles. Lane (lq, lt) = (lane % 4, lane / 4) keeps NI x NU
//   accumulators (at most 8 x 8): query tokens 32*wq + lq + 4i against
//   rows lt + 8u. Per float4 step along d it reads NI + NU float4s of
//   shared memory for 4*NI*NU FMAs (4 FMAs per float read at 8 x 8); the
//   8 lanes that share lq read one query address, the 4 that share lt
//   one row. NI stops at the row's last real query token (a padded one
//   contributes 0 either way), NU at the item's last valid group; both
//   are template arguments, so the tile has no dead lanes.
// - The max. When an item's last slice is scored, each warp folds its
//   accumulators into a per-(candidate, column, query token) slot in
//   shared memory. After the last item, one warp per candidate takes the
//   max over the columns' slots and sums with `query_sum`.
// - The grid: two blocks per SM. G is chosen for about three waves of
//   them, and the last blocks to start take fewer candidates (Schedule),
//   so the card drains evenly. Up to 396 candidates G = 1: a single
//   query at C=200 gives 200 blocks, at least one on each of the 132
//   SMs, and each candidate's chunks spread over the block's columns.
#include <cuda.h>
#include <cudaTypedefs.h>

#include <algorithm>
#include <cstring>

#include "score_tile.cuh"

namespace {

constexpr int kStages = 2;
constexpr int kChunk = 64;                       // positions of an item
constexpr int kGroup = 8;                        // rows of one copy
constexpr int kSlice = 32;                       // floats of d per stage
constexpr int kBoxBytes = kGroup * kSlice * 4;   // 1 KB
constexpr int kColBytes = kChunk * kSlice * 4;   // 8 KB: a column's rows
constexpr int kMaxCols = 4;                      // WT, and WQ * WT
constexpr int kMaxGroup = 16;                    // candidates of a block
constexpr int kMaxTile = 8;                      // NI, NU
constexpr int kScanBatch = 4;                    // chunks' flags in flight
constexpr int kTable = 256;                      // chunk masks held at once,
constexpr int kTableMin = 32;                    // or these if space is tight
constexpr int kThreads = (kMaxCols + 1) * 32;
constexpr size_t kSmemLimit = 232448;

struct Shape {
  int wq, wt, G, tab;
};

// The grid's blocks in launch order: first groups of G[0] candidates of
// every row (kHeadShare % of each row's candidates), then groups of G[1]
// (kMidShare % of the rest), then of G[2] for the rest, so that the last
// blocks to start are short and the card drains evenly.
constexpr int kLevels = 3;
constexpr int kHeadShare = 70;
constexpr int kMidShare = 60;
struct Schedule {
  int G[kLevels];          // candidates of a block
  int start[kLevels + 1];  // a row's first candidate at each level; C
  int per_row[kLevels];    // blocks of a row at each level
  int first[kLevels + 1];  // the first block of each level; the grid
};

inline Schedule make_schedule(int B, int C, int G0) {
  Schedule sc;
  sc.G[0] = G0;
  sc.G[1] = std::max(1, G0 / 2);
  sc.G[2] = std::max(1, G0 / 4);
  const int n0 = static_cast<int>((long)C * kHeadShare / 100 / G0 * G0);
  const int n1 = static_cast<int>((long)(C - n0) * kMidShare / 100 / sc.G[1] * sc.G[1]);
  const int n[kLevels] = {n0, n1, C - n0 - n1};
  sc.start[0] = 0;
  sc.first[0] = 0;
  for (int l = 0; l < kLevels; ++l) {
    sc.start[l + 1] = sc.start[l] + n[l];
    sc.per_row[l] = (n[l] + sc.G[l] - 1) / sc.G[l];
    sc.first[l + 1] = sc.first[l] + B * sc.per_row[l];
  }
  return sc;
}

// What the producer tells column `wt` about its item: the candidate of
// the block, the number of 8-row groups copied (0: no item this round;
// -1: no items left), and the valid rows among them (bit r: row r).
struct Meta {
  int g;
  int ngroups;
  unsigned long long mask;
};

__host__ __device__ inline size_t round_up(size_t n, size_t m) {
  return (n + m - 1) / m * m;
}

// Shared memory of one block, in bytes: the stages (at the start, whose
// 1,024-byte alignment the swizzle needs), the query, the (G, WT, Lq)
// slots, the chunk table, the query's flags, the stages' Meta, and two
// barriers per stage. Every shape the one-warp-per-candidate body took,
// (Lq (d + 4) + 8 d + 16) floats at most, fits.
__host__ __device__ inline size_t smem_bytes(int Lq, int d, Shape s) {
  return (size_t)kStages * s.wt * kColBytes + (size_t)Lq * d * 4 +
         round_up((size_t)s.G * s.wt * Lq * 4, 16) + (size_t)s.tab * 8 +
         round_up(Lq, 16) + (size_t)kStages * s.wt * sizeof(Meta) +
         2 * kStages * 8;
}

// WQ covers the query tokens in passes of 32; WT = 4 / WQ columns; G
// from the candidate count `pairs`; fewer columns, candidates and table
// entries if the block would not fit.
inline Shape choose_shape(int Lq, int d, long pairs, int n_sm) {
  const int wq = std::max(1, (Lq + 31) / 32);
  const long want = 3L * n_sm;
  const int G = static_cast<int>(
      std::min<long>(kMaxGroup, std::max<long>(1, (pairs + want - 1) / want)));
  for (int tab : {kTable, kTableMin}) {
    for (int wt = std::max(1, kMaxCols / wq); wt >= 1; wt /= 2) {
      for (int g = G; g >= 1; g /= 2) {
        const Shape s{wq, wt, g, tab};
        if (smem_bytes(Lq, d, s) <= kSmemLimit) return s;
      }
    }
  }
  return Shape{wq, 1, 1, kTableMin};  // too large: the wrapper refuses it
}

int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0, v = 0;
    if (cudaGetDevice(&dev) == cudaSuccess &&
        cudaDeviceGetAttribute(&v, cudaDevAttrMultiProcessorCount, dev) ==
            cudaSuccess) {
      n = v;
    } else {
      return 132;
    }
  }
  return n;
}

__device__ inline uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ inline void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ inline void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ inline void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}

__device__ inline void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// One box of a (rows, d) tensor map, from column x, row y, into `dst`
// (1,024-byte aligned), completing on `bar`.
__device__ inline void tma_box(void* dst, const CUtensorMap* map, int x, int y,
                               uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y), "r"(smem_u32(bar))
      : "memory");
}

struct Block {
  const CUtensorMap* docs_map;  // (B*C*Ld, d), boxes of 8 rows x 32 floats
  const CUtensorMap* chunk_map; // the same, boxes of 64 rows x 32 floats
  const uint8_t* valid;
  int b, C, c0, Gn, Ld, Lq, d, wt_n, n_cons;
  int nk;                    // chunks of a candidate
  int tab;                   // entries of the chunk table
  unsigned char* stages;     // (kStages, WT) x kColBytes
  const float* qs;           // (Lq, d), float4 c of row r at c ^ (r & 7)
  float* slots;              // (G, WT, Lq)
  unsigned long long* table; // tab chunk masks (bit r: position r)
  uint8_t* q_flags;          // q_valid of row b
  Meta* meta;                // (kStages, WT)
  uint64_t* full;            // kStages
  uint64_t* empty;           // kStages
};

// One warp: the valid masks of chunks base + i, for i = first, first +
// step, ... below cnt, into table[i]; kScanBatch chunks' flags are
// loaded before their ballots, so their loads are in flight together.
__device__ __forceinline__ void scan(const Block& k, int base, int first,
                                     int cnt, int step) {
  const int lane = threadIdx.x % 32;
  for (int i0 = first; i0 < cnt; i0 += kScanBatch * step) {
    bool f[kScanBatch][2];
#pragma unroll
    for (int u = 0; u < kScanBatch; ++u) {
      const int i = i0 + u * step;
      f[u][0] = f[u][1] = false;
      if (i < cnt) {
        const int it = base + i, p = (it % k.nk) * kChunk + lane;
        const uint8_t* v = k.valid + ((size_t)k.b * k.C + k.c0 + it / k.nk) * k.Ld;
        f[u][0] = p < k.Ld && v[p];
        f[u][1] = p + 32 < k.Ld && v[p + 32];
      }
    }
#pragma unroll
    for (int u = 0; u < kScanBatch; ++u) {
      const unsigned lo = __ballot_sync(0xffffffffu, f[u][0]);
      const unsigned hi = __ballot_sync(0xffffffffu, f[u][1]);
      const int i = i0 + u * step;
      if (lane == 0 && i < cnt) {
        k.table[i] = (static_cast<unsigned long long>(hi) << 32) | lo;
      }
    }
  }
}

// The 8-row groups an item copies: from the one of its first valid
// position to the one of its last (0 for an empty chunk).
__device__ inline int item_groups(unsigned long long mask) {
  if (mask == 0) return 0;
  return (63 - __clzll(static_cast<long long>(mask))) / kGroup -
         (__ffsll(static_cast<long long>(mask)) - 1) / kGroup + 1;
}

// ---------------------------------------------------------------------------
// producer: one warp
// ---------------------------------------------------------------------------

// The item of column `col` sits in lane `col`'s registers.
struct Held {
  int g = 0, j = 0, g0 = 0, ng = 0;
  unsigned long long mask = 0;
};

// Copies the n held items through their d / 32 stages: lane l copies
// group l % 8 of column l / 8's item.
static_assert(kMaxCols * kGroup <= 32, "a box per producer lane");
__device__ __forceinline__ void emit_round(const Block& k, const Held& h, int n,
                                           uint32_t& t) {
  const int lane = threadIdx.x % 32;
  const int ng = lane < n ? h.ng : 0;
  int total = ng;
#pragma unroll
  for (int o = 16; o >= 1; o /= 2) total += __shfl_xor_sync(0xffffffffu, total, o);
  const int col = lane / kGroup, grp = lane % kGroup;
  const int cg = __shfl_sync(0xffffffffu, h.g, col);
  const int cj = __shfl_sync(0xffffffffu, h.j, col);
  const int cg0 = __shfl_sync(0xffffffffu, h.g0, col);
  const int cng = __shfl_sync(0xffffffffu, ng, col);
  const int y = ((k.b * k.C + k.c0 + cg) * k.Ld) + cj * kChunk + (cg0 + grp) * kGroup;
  for (int s = 0; s < k.d / kSlice; ++s, ++t) {
    const int st = t % kStages;
    mbar_wait(&k.empty[st], ((t / kStages) & 1) ^ 1);
    if (s == 0 && lane < k.wt_n) {
      Meta m;
      m.g = h.g;
      m.ngroups = ng;
      m.mask = h.mask;
      k.meta[st * k.wt_n + lane] = m;
    }
    __syncwarp();
    if (lane == 0) mbar_expect_tx(&k.full[st], total * kBoxBytes);
    __syncwarp();
    if (col < n && cng == kChunk / kGroup) {  // a whole chunk: one box
      if (grp == 0) {
        tma_box(k.stages + (size_t)(st * k.wt_n + col) * kColBytes, k.chunk_map,
                s * kSlice, y, &k.full[st]);
      }
    } else if (col < n && grp < cng) {
      tma_box(k.stages + (size_t)(st * k.wt_n + col) * kColBytes + grp * kBoxBytes,
              k.docs_map, s * kSlice, y, &k.full[st]);
    }
  }
}

// Hands the block's items to the columns, a round being WT items, in
// windows of `tab` chunks (the first scanned by the whole block): per
// window, those of NU = 8 first, down to NU = 1.
__device__ __forceinline__ void produce(const Block& k) {
  const int lane = threadIdx.x % 32;
  const int n_all = k.Gn * k.nk;
  uint32_t t = 0;
  Held h;
  int n = 0;
  for (int base = 0; base < n_all; base += k.tab) {
    const int cnt = min(k.tab, n_all - base);
    if (base > 0) {
      scan(k, base, 0, cnt, 1);
      __syncwarp();
    }
    for (int nu = kMaxTile; nu >= 1; --nu) {
      for (int w = 0; w < cnt; w += 32) {
        const unsigned long long mk = w + lane < cnt ? k.table[w + lane] : 0ull;
        unsigned sel = __ballot_sync(0xffffffffu, item_groups(mk) == nu);
        while (sel) {
          const int src = __ffs(sel) - 1;
          sel &= sel - 1;
          const unsigned long long mask = __shfl_sync(0xffffffffu, mk, src);
          const int it = base + w + src;
          if (lane == n) {
            h.g = it / k.nk;
            h.j = it % k.nk;
            h.g0 = (__ffsll(static_cast<long long>(mask)) - 1) / kGroup;
            h.ng = nu;
            h.mask = mask >> (kGroup * h.g0);
          }
          if (++n == k.wt_n) {
            emit_round(k, h, n, t);
            n = 0;
          }
        }
      }
    }
  }
  if (n > 0) emit_round(k, h, n, t);
  // no items left
  const int st = t % kStages;
  mbar_wait(&k.empty[st], ((t / kStages) & 1) ^ 1);
  if (lane < k.wt_n) k.meta[st * k.wt_n + lane].ngroups = -1;
  __syncwarp();
  if (lane == 0) mbar_arrive(&k.full[st]);
}

// ---------------------------------------------------------------------------
// consumers: WQ x WT warps
// ---------------------------------------------------------------------------

__device__ inline void release(const Block& k, uint32_t& t) {
  __syncwarp();
  if (threadIdx.x % 32 == 0) mbar_arrive(&k.empty[t % kStages]);
  ++t;
}

// One item: NI x NU tiles over its d / 32 slices (the first one's stage
// already waited for), then the fold into the candidate's slots.
template <int NI, int NU>
__device__ __forceinline__ void score_item(const Block& k, int wq, int wt,
                                           const Meta& m, uint32_t& t) {
  const int lane = threadIdx.x % 32, lq = lane % 4, lt = lane / 4;
  const float4* qrow[NI];
  int qsw[NI];
#pragma unroll
  for (int i = 0; i < NI; ++i) {
    // past the last query row a lane reads that row; the fold drops it
    const int qi = min(32 * wq + lq + 4 * i, k.Lq - 1);
    qrow[i] = reinterpret_cast<const float4*>(k.qs) + (size_t)qi * (k.d / 4);
    qsw[i] = qi & 7;
  }
  float acc[NI][NU];
#pragma unroll
  for (int i = 0; i < NI; ++i) {
#pragma unroll
    for (int u = 0; u < NU; ++u) acc[i][u] = 0.f;
  }
  const int ns = k.d / kSlice;
  for (int s = 0; s < ns; ++s) {
    const int st = t % kStages;
    if (s > 0) mbar_wait(&k.full[st], (t / kStages) & 1);
    const float4* tile = reinterpret_cast<const float4*>(
                             k.stages + (size_t)(st * k.wt_n + wt) * kColBytes) +
                         lt * (kSlice / 4);
#pragma unroll 1
    for (int c = 0; c < kSlice / 4; ++c) {
      float4 y[NU];
#pragma unroll
      for (int u = 0; u < NU; ++u) y[u] = tile[u * kGroup * (kSlice / 4) + (c ^ lt)];
#pragma unroll
      for (int i = 0; i < NI; ++i) {
        const float4 x = qrow[i][s * (kSlice / 4) + (c ^ qsw[i])];
#pragma unroll
        for (int u = 0; u < NU; ++u) {
          acc[i][u] = fmaf(x.x, y[u].x, acc[i][u]);
          acc[i][u] = fmaf(x.y, y[u].y, acc[i][u]);
          acc[i][u] = fmaf(x.z, y[u].z, acc[i][u]);
          acc[i][u] = fmaf(x.w, y[u].w, acc[i][u]);
        }
      }
    }
    release(k, t);
  }
  float* slot = k.slots + (size_t)(m.g * k.wt_n + wt) * k.Lq;
#pragma unroll
  for (int i = 0; i < NI; ++i) {
    float v = rt::kNeg;
#pragma unroll
    for (int u = 0; u < NU; ++u) {
      if ((m.mask >> (lt + kGroup * u)) & 1ull) v = fmaxf(v, acc[i][u]);
    }
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 4));
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 8));
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 16));
    const int qi = 32 * wq + lq + 4 * i;
    if (lt == 0 && qi < k.Lq) slot[qi] = fmaxf(slot[qi], v);
  }
}

template <int NI, int NU = kMaxTile>
__device__ __forceinline__ void score_nu(const Block& k, int wq, int wt,
                                         const Meta& m, uint32_t& t) {
  if constexpr (NU > 1) {
    if (m.ngroups < NU) {
      score_nu<NI, NU - 1>(k, wq, wt, m, t);
      return;
    }
  }
  score_item<NI, NU>(k, wq, wt, m, t);
}

template <int NI = kMaxTile>
__device__ __forceinline__ void score_ni(int ni, const Block& k, int wq, int wt,
                                         const Meta& m, uint32_t& t) {
  if constexpr (NI > 1) {
    if (ni < NI) {
      score_ni<NI - 1>(ni, k, wq, wt, m, t);
      return;
    }
  }
  score_nu<NI>(k, wq, wt, m, t);
}

__device__ __forceinline__ void consume(const Block& k, int wq, int wt, int nq) {
  // this pass's query tokens up to the row's last real one, 4 a step
  const int ni = min(kMaxTile, max(0, (nq - 32 * wq + 3) / 4));
  const int ns = k.d / kSlice;
  uint32_t t = 0;
  for (;;) {
    mbar_wait(&k.full[t % kStages], (t / kStages) & 1);
    const Meta m = k.meta[(t % kStages) * k.wt_n + wt];
    if (m.ngroups < 0) break;
    if (ni > 0 && m.ngroups > 0) {
      score_ni(ni, k, wq, wt, m, t);
    } else {  // nothing to score: pass the item's stages on
      for (int s = 0; s < ns; ++s) {
        if (s > 0) mbar_wait(&k.full[t % kStages], (t / kStages) & 1);
        release(k, t);
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads, 2)
maxsim_kernel(const __grid_constant__ CUtensorMap docs_map,
              const __grid_constant__ CUtensorMap chunk_map,
              const float* __restrict__ q, const uint8_t* __restrict__ valid,
              const uint8_t* __restrict__ q_valid, float* __restrict__ out,
              int C, int Ld, int Lq, int d, int wq_n, int wt_n, int G,
              int tab, Schedule sc) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  int level = 0;
  while (level + 1 < kLevels && (int)blockIdx.x >= sc.first[level + 1]) ++level;
  const int r = blockIdx.x - sc.first[level];
  const int b = r / sc.per_row[level];
  const int c0 = sc.start[level] + (r % sc.per_row[level]) * sc.G[level];
  const int n_cons = wq_n * wt_n;

  Block k;
  k.docs_map = &docs_map;
  k.chunk_map = &chunk_map;
  k.valid = valid;
  k.b = b;
  k.C = C;
  k.c0 = c0;
  k.Gn = min(sc.G[level], sc.start[level + 1] - c0);
  k.Ld = Ld;
  k.Lq = Lq;
  k.d = d;
  k.wt_n = wt_n;
  k.n_cons = n_cons;
  k.nk = (Ld + kChunk - 1) / kChunk;
  k.tab = tab;
  // the copies' swizzle and the consumers' XOR agree only on a
  // 1,024-byte aligned base, which the declaration asks for
  if (smem_u32(smem_raw) & 1023) __trap();
  k.stages = smem_raw;
  float* qs = reinterpret_cast<float*>(k.stages + (size_t)kStages * wt_n * kColBytes);
  k.qs = qs;
  k.slots = qs + (size_t)Lq * d;
  k.table = reinterpret_cast<unsigned long long*>(
      reinterpret_cast<unsigned char*>(k.slots) + round_up((size_t)G * wt_n * Lq * 4, 16));
  k.q_flags = reinterpret_cast<uint8_t*>(k.table + tab);
  k.meta = reinterpret_cast<Meta*>(k.q_flags + round_up(Lq, 16));
  k.full = reinterpret_cast<uint64_t*>(k.meta + kStages * wt_n);
  k.empty = k.full + kStages;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&k.full[s], 1);
      mbar_init(&k.empty[s], n_cons);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // the query, swizzled as the stages are
  const int d4 = d / 4;
  const float4* q4 = reinterpret_cast<const float4*>(q + (size_t)b * Lq * d);
  float4* qs4 = reinterpret_cast<float4*>(qs);
  for (int i = threadIdx.x; i < Lq * d4; i += blockDim.x) {
    const int r = i / d4, c = i % d4;
    qs4[r * d4 + (c ^ (r & 7))] = q4[i];
  }
  for (int i = threadIdx.x; i < k.Gn * wt_n * Lq; i += blockDim.x) k.slots[i] = rt::kNeg;
  // the row's query flags, and one past its last real query token
  int last = -1;
  for (int r = lane; r < Lq; r += 32) {
    const uint8_t f = q_valid[(size_t)b * Lq + r];
    if (warp == 0) k.q_flags[r] = f;
    if (f) last = r;
  }
  const int nq = __reduce_max_sync(0xffffffffu, last) + 1;
  // the chunks' masks, as far as the table holds them, by every warp
  scan(k, 0, warp, min(tab, k.Gn * k.nk), n_cons + 1);
  __syncthreads();

  if (warp == n_cons) {
    produce(k);
  } else {
    consume(k, warp / wt_n, warp % wt_n, nq);
  }
  __syncthreads();

  // a warp per candidate: the max over the columns' slots, then the sum
  for (int g = warp; g < k.Gn; g += n_cons + 1) {
    float m[rt::kMaxLqPerLane];
#pragma unroll
    for (int r = 0; r < rt::kMaxLqPerLane; ++r) {
      const int qi = r * 32 + lane;
      m[r] = rt::kNeg;
      if (qi < Lq) {
        for (int w = 0; w < wt_n; ++w) {
          m[r] = fmaxf(m[r], k.slots[(g * wt_n + w) * Lq + qi]);
        }
      }
    }
    const float score = rt::query_sum(m, k.q_flags, Lq, lane);
    if (lane == 0) out[(size_t)b * C + c0 + g] = score;
  }
}

PFN_cuTensorMapEncodeTiled_v12000 encode_fn() {
  static PFN_cuTensorMapEncodeTiled_v12000 fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess) {
      fn = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(p);
    }
  }
  return fn;
}

// docs as a (rows, d) fp32 matrix, copied in boxes of box_rows x 32
// floats with the 128-byte swizzle; a zeroed map when it has no rows.
cudaError_t encode(CUtensorMap* map, const void* base, int d, long rows,
                   int box_rows) {
  std::memset(map, 0, sizeof *map);
  if (rows == 0) return cudaSuccess;
  const PFN_cuTensorMapEncodeTiled_v12000 fn = encode_fn();
  if (fn == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)d, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)d * 4};
  const cuuint32_t box[2] = {kSlice, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2,
                        const_cast<void*>(base), dims, strides, box, elem,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace

extern "C" size_t maxsim_smem_bytes(int Lq, int d, int B, int C) {
  return smem_bytes(Lq, d, choose_shape(Lq, d, (long)B * C, sm_count()));
}

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// q and docs must be 16-byte aligned and B*C*Ld below 2^31 (a copy's row
// coordinate is a 32-bit int); the wrapper sees to both.
extern "C" int maxsim_launch(const void* q, const void* docs,
                             const void* valid, const void* q_valid,
                             void* out, int B, int C, int Ld, int Lq, int d,
                             void* stream) {
  const Shape s = choose_shape(Lq, d, (long)B * C, sm_count());
  const size_t smem = smem_bytes(Lq, d, s);
  cudaError_t err = cudaFuncSetAttribute(
      maxsim_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      rt::kMaxSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  CUtensorMap docs_map, chunk_map;
  err = encode(&docs_map, docs, d, (long)B * C * Ld, kGroup);
  if (err == cudaSuccess) err = encode(&chunk_map, docs, d, (long)B * C * Ld, kChunk);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Schedule sc = make_schedule(B, C, s.G);
  maxsim_kernel<<<sc.first[kLevels], (s.wq * s.wt + 1) * 32, smem,
                  static_cast<cudaStream_t>(stream)>>>(
      docs_map, chunk_map, static_cast<const float*>(q),
      static_cast<const uint8_t*>(valid),
      static_cast<const uint8_t*>(q_valid), static_cast<float*>(out), C, Ld,
      Lq, d, s.wq, s.wt, s.G, s.tab, sc);
  return static_cast<int>(cudaGetLastError());
}
