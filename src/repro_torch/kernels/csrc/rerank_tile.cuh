// Register-tiled decompress+MaxSim tile body of the rerank tail's two
// kernels (decompress_maxsim.cu, fused_rerank.cu).
//
// Counterpart of `_score_tile` in the JAX package
// (src/repro/kernels/decompress_maxsim/decompress_maxsim.py:64), which
// both compressed-candidate TPU kernels call. Both CUDA kernels launch
// `score_kernel` below, so the fused rerank tail equals the split tail
// bit for bit.
//
// The per-pair arithmetic is that of score_tile.cuh, which the MaxSim
// kernel over fp32 embeddings (maxsim.cu) keeps in its own tiling, so on
// decoded embeddings the two agree bit for bit:
// - decode: e[j] = centroids[cid][j] + bucket_weights[code_j], one fp32
//   add;
// - each (query token, doc token) dot product: one fmaf chain over
//   j = 0 .. d-1, ascending, from 0.f;
// - the per-query-token max over the candidate's valid tokens from the
//   kNeg sentinel (fmaxf is exact, so the order of the max is free);
// - `query_sum`'s masking and ascending sum over query tokens.
// The tiling below only changes which thread computes which pair and
// when, never the order of a pair's own operations.
//
// Layout. A block scores a group of G candidates of one batch row (G = 1
// when the batch is small, so a single query spreads over C blocks). Its
// W warps work independently: the group's token positions are cut into
// windows of P positions (an "item"), and warp w takes items w, w + W,
// ... in order. For each item the warp
// - loads the window's valid flags and centroid ids (one item ahead, in
//   registers), compacts the valid tokens with a ballot, and copies their
//   centroid rows (16-byte cp.async, through L2) and packed codes
//   (8-byte cp.async) into its own shared buffer, each lane its own
//   token's;
// - decodes the rows in place (row + bucket weight);
// - scores them against the query, which the block holds in shared
//   memory, in 4 x 4 register tiles: lane (tq, tt) takes query tokens
//   tq + 8i and doc tokens tt + 4u, 16 independent fmaf chains fed by 8
//   float4 reads of shared memory per 64 FMAs (2 FMAs per float read;
//   the 8 lanes of a quarter-warp share tt, so the doc reads broadcast).
//   Query tokens run in passes of 32 (Lq <= 128).
// Only __syncwarp orders a warp's steps, so while one warp waits for its
// copies the SM's other warps (16 at the serve shape: 2 blocks of 8)
// compute: latency is hidden by warps, not by stages. A second buffer
// per warp halves the warps an SM holds, and was slower. When a warp
// moves on to the next candidate it stores its maxima for the last one
// in its own slot of a per-candidate table; after one block barrier, a
// warp per candidate takes the max over the slots and sums over query
// tokens with `query_sum`. No tensor cores (IEEE fp32 is the contract),
// no atomics.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "score_tile.cuh"

namespace rt {

constexpr int kMaxWarps = 8;    // warps of a block
constexpr int kWindow = 16;     // token positions of an item: 4 lanes x 4
constexpr int kMaxGroup = 4;    // candidates of a block
constexpr int kQPasses = 4;     // passes of 32 query tokens: Lq <= 128
constexpr int kSmemLimit = 232448;

struct TileArgs {
  const float* q;               // (B, Lq, d) f32
  const uint8_t* packed;        // (B, C, Ld, d*nbits/8) u8
  const int32_t* cids;          // (B, C, Ld) i32
  const uint8_t* valid;         // (B, C, Ld) 0/1
  const uint8_t* q_valid;       // (B, Lq) 0/1
  const float* centroids;       // (K, d) f32
  const float* bucket_weights;  // (2^nbits,) f32
  int C, Ld, Lq, d, nbits;
};

// W warps of P positions each, G candidates per block.
struct TileShape {
  int W, P, G;
};

__host__ __device__ inline size_t round16(size_t n) { return (n + 15) / 16 * 16; }

// Shared memory of one block, in bytes: the query rows (stride d + 4
// floats keeps float4 rows aligned and spreads the 8 query tokens a
// quarter-warp reads over distinct banks), each warp's P token rows and
// P packed-code rows, the per-candidate, per-warp maxima and the bucket
// table.
__host__ __device__ inline size_t tile_bytes(int Lq, int d, int nbits,
                                             TileShape t) {
  const size_t stride = (size_t)q_stride(d) * sizeof(float);
  const size_t stage = (size_t)t.P * stride + round16((size_t)t.P * d * nbits / 8);
  return (size_t)Lq * stride + t.W * stage +
         round16((size_t)t.G * t.W * Lq * sizeof(float)) +
         kMaxBuckets * sizeof(float);
}

// The block's shape for `pairs` = B*C candidates: G so that the grid
// keeps some 8 blocks per SM of a 132-SM card, then the largest W and P
// whose tile fits in a block's shared memory ({1, 4, 1} when none does,
// and the wrapper then refuses the shape).
inline TileShape tile_shape(int Lq, int d, int nbits, long pairs) {
  const long per = pairs / (132L * 8);
  const int G = static_cast<int>(per < 1 ? 1 : per > kMaxGroup ? kMaxGroup : per);
  for (int P = kWindow; P >= 4; P /= 2) {
    for (int W = kMaxWarps; W >= 1; W /= 2) {
      for (int g = G; g >= 1; g /= 2) {
        const TileShape t{W, P, g};
        if (tile_bytes(Lq, d, nbits, t) <= kSmemLimit) return t;
      }
    }
  }
  return TileShape{1, 4, 1};
}

__device__ inline void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

__device__ inline void cp_async8(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s),
               "l"(src));
}

__device__ inline void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::);
}

// The block's candidates: the group [c0, c0 + G) of row b, without the
// ones `cmask` drops.
struct Group {
  const uint8_t* cmask;  // (B, C) or nullptr: score every candidate
  int b, c0, G, C;

  __device__ bool keeps(int g) const {
    return cmask == nullptr || cmask[(size_t)b * C + c0 + g];
  }
  __device__ int kept() const {
    int n = 0;
    for (int g = 0; g < G; ++g) n += keeps(g);
    return n;
  }
  // the candidate index of the kc-th kept candidate
  __device__ int cand(int kc) const {
    for (int g = 0; g < G; ++g) {
      if (keeps(g) && kc-- == 0) return c0 + g;
    }
    return -1;
  }
};

// An item in a warp's registers: lane i < P holds position t0 + i.
struct Item {
  int kc, c, t0;
  bool ok;
  int cid;
};

__device__ inline Item load_item(const TileArgs& a, const Group& g,
                                 int item, int nw, int P) {
  const int lane = threadIdx.x % 32;
  Item it;
  it.kc = item / nw;
  it.c = g.cand(it.kc);
  it.t0 = (item % nw) * P;
  const int t = it.t0 + lane;
  const bool in = lane < P && t < a.Ld;
  const size_t tok = ((size_t)g.b * a.C + it.c) * a.Ld + t;
  it.cid = in ? a.cids[tok] : 0;
  it.ok = in && a.valid[tok];
  return it;
}

// One warp: start copying the item's valid rows (compacted, in position
// order) into `rows` and their packed codes into `codes`, each lane the
// row of its own position. Returns the number of valid tokens.
__device__ inline int stage_rows(const TileArgs& a, int b, const Item& it,
                                 float* rows, uint8_t* codes) {
  const int lane = threadIdx.x % 32;
  const int d = a.d, pd = d * a.nbits / 8;
  const unsigned mask = __ballot_sync(0xffffffffu, it.ok);
  if (it.ok) {
    const int slot = __popc(mask & ((1u << lane) - 1u));
    const float* crow = a.centroids + (size_t)it.cid * d;
    float* dst = rows + (size_t)slot * q_stride(d);
    for (int j = 0; j < d; j += 4) cp_async16(dst + j, crow + j);
    const uint8_t* prow =
        a.packed + (((size_t)b * a.C + it.c) * a.Ld + it.t0 + lane) * pd;
    uint8_t* cdst = codes + (size_t)slot * pd;
    for (int j = 0; j < pd; j += 8) cp_async8(cdst + j, prow + j);
  }
  return __popc(mask);
}

// One warp, once the item's copies have landed: rows[s][j] +=
// bw[code of (s, j)]. Lane l takes float4 column l (and l + 32, ...) of
// four rows at a time, all loads before any store; the four codes of a
// float4 come from one 16-bit (nbits=4) or 8-bit (nbits=2) word of the
// packed row.
__device__ inline void decode(const TileArgs& a, float* rows,
                              const uint8_t* codes, const float* bw, int nv) {
  const int lane = threadIdx.x % 32;
  const int d = a.d, nbits = a.nbits, pd = d * nbits / 8, rs = q_stride(d);
  const unsigned code_mask = (1u << nbits) - 1u;
  for (int j4 = lane; j4 < d / 4; j4 += 32) {
    for (int s0 = 0; s0 < nv; s0 += 4) {
      float4 v[4];
      unsigned bits[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int s = min(s0 + k, nv - 1);
        const uint8_t* cr = codes + (size_t)s * pd;
        bits[k] = nbits == 4 ? *reinterpret_cast<const uint16_t*>(cr + 2 * j4)
                             : cr[j4];
        v[k] = reinterpret_cast<const float4*>(rows + (size_t)s * rs)[j4];
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        v[k].x = v[k].x + bw[bits[k] & code_mask];
        v[k].y = v[k].y + bw[(bits[k] >> nbits) & code_mask];
        v[k].z = v[k].z + bw[(bits[k] >> (2 * nbits)) & code_mask];
        v[k].w = v[k].w + bw[(bits[k] >> (3 * nbits)) & code_mask];
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (s0 + k < nv) {
          reinterpret_cast<float4*>(rows + (size_t)(s0 + k) * rs)[j4] = v[k];
        }
      }
    }
  }
}

// One lane's 4 x 4 micro-tile over the warp's nv decoded tokens: query
// tokens p*32 + tq + 8i, doc tokens tt + 4u; folds each dot product into
// the running max of its query token.
__device__ inline void tile_max(const TileArgs& a, const float* qs,
                                const float* rows, int nv,
                                float (&m)[kQPasses][4]) {
  const int lane = threadIdx.x % 32, tq = lane % 8, tt = lane / 8;
  if (tt >= nv) return;
  const int d = a.d, rs = q_stride(d);
  const float4* e4[4];
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    e4[u] = reinterpret_cast<const float4*>(
        rows + (size_t)min(tt + 4 * u, nv - 1) * rs);
  }
#pragma unroll
  for (int p = 0; p < kQPasses; ++p) {
    if (p * 32 >= a.Lq) break;
    const float4* q4[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      q4[i] = reinterpret_cast<const float4*>(
          qs + (size_t)min(p * 32 + tq + 8 * i, a.Lq - 1) * rs);
    }
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int u = 0; u < 4; ++u) acc[i][u] = 0.f;
    }
#pragma unroll 2
    for (int j = 0; j < d / 4; ++j) {
      float4 x[4], y[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) x[i] = q4[i][j];
#pragma unroll
      for (int u = 0; u < 4; ++u) y[u] = e4[u][j];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          acc[i][u] = fmaf(x[i].x, y[u].x, acc[i][u]);
          acc[i][u] = fmaf(x[i].y, y[u].y, acc[i][u]);
          acc[i][u] = fmaf(x[i].z, y[u].z, acc[i][u]);
          acc[i][u] = fmaf(x[i].w, y[u].w, acc[i][u]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        if (tt + 4 * u < nv) m[p][i] = fmaxf(m[p][i], acc[i][u]);
      }
    }
  }
}

// One warp: store its maxima of one candidate in its slot (max over the
// lanes that share a query token), and reset them.
__device__ inline void flush(int Lq, float* slot, float (&m)[kQPasses][4]) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int p = 0; p < kQPasses; ++p) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float v = m[p][i];
      v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 8));
      v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 16));
      const int qi = p * 32 + lane + 8 * i;
      if (lane < 8 && qi < Lq) slot[qi] = v;
      m[p][i] = kNeg;
    }
  }
}

namespace {

// Scores (B, C) into `out`: block (x, b) scores candidates
// [x*G, x*G + G) of row b with blockDim.x / 32 warps and windows of P
// positions. With `cmask`, a masked candidate is not read and scores
// -inf.
__global__ void __launch_bounds__(kMaxWarps * 32, 2)
score_kernel(TileArgs a, const uint8_t* __restrict__ cmask, int G, int P,
             float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int W = blockDim.x / 32, warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int b = blockIdx.y, c0 = blockIdx.x * G;
  const Group grp{cmask, b, c0, min(G, a.C - c0), a.C};
  for (int g = threadIdx.x; g < grp.G; g += blockDim.x) {
    if (!grp.keeps(g)) {
      out[(size_t)b * a.C + c0 + g] = __int_as_float(static_cast<int>(0xff800000u));
    }
  }
  const int kept = grp.kept();
  if (kept == 0) return;

  const int d = a.d, pd = d * a.nbits / 8;
  const size_t stride = (size_t)q_stride(d);
  float* qs = reinterpret_cast<float*>(smem_raw);
  unsigned char* wbuf = reinterpret_cast<unsigned char*>(qs + (size_t)a.Lq * stride);
  const size_t stage_bytes = (size_t)P * stride * sizeof(float) + round16((size_t)P * pd);
  float* const rows = reinterpret_cast<float*>(wbuf + warp * stage_bytes);
  uint8_t* const codes = reinterpret_cast<uint8_t*>(rows + (size_t)P * stride);
  float* slots = reinterpret_cast<float*>(wbuf + W * stage_bytes);  // (kept, W, Lq)
  float* bw = slots + round16((size_t)G * W * a.Lq * sizeof(float)) / sizeof(float);

  // the query rows (a warp per row), the bucket table, and this warp's
  // slots at kNeg (a warp that sees no token of a candidate keeps them)
  for (int r = warp; r < a.Lq; r += W) {
    const float4* src =
        reinterpret_cast<const float4*>(a.q + ((size_t)b * a.Lq + r) * d);
    float4* dst = reinterpret_cast<float4*>(qs + r * stride);
    for (int j4 = lane; j4 < d / 4; j4 += 32) dst[j4] = src[j4];
  }
  if (threadIdx.x < (1 << a.nbits)) bw[threadIdx.x] = a.bucket_weights[threadIdx.x];
  for (int kc = 0; kc < kept; ++kc) {
    for (int qi = lane; qi < a.Lq; qi += 32) slots[(kc * W + warp) * a.Lq + qi] = kNeg;
  }
  __syncthreads();

  const int nw = (a.Ld + P - 1) / P;
  const int n_items = kept * nw;
  float m[kQPasses][4];
#pragma unroll
  for (int p = 0; p < kQPasses; ++p) {
#pragma unroll
    for (int i = 0; i < 4; ++i) m[p][i] = kNeg;
  }
  // the warp's items are warp, warp + W, ...; the next one's flags and
  // ids are in flight to registers while one is staged and scored
  int cur = -1;  // the kept candidate the maxima belong to
  Item next;
  if (warp < n_items) next = load_item(a, grp, warp, nw, P);
  for (int item = warp; item < n_items; item += W) {
    const Item it = next;
    if (item + W < n_items) next = load_item(a, grp, item + W, nw, P);
    if (it.kc != cur) {
      if (cur >= 0) flush(a.Lq, slots + (size_t)(cur * W + warp) * a.Lq, m);
      cur = it.kc;
    }
    const int nv = stage_rows(a, b, it, rows, codes);
    if (nv == 0) continue;
    cp_async_wait_all();
    __syncwarp();  // every lane's copies have landed
    decode(a, rows, codes, bw, nv);
    __syncwarp();
    tile_max(a, qs, rows, nv, m);
    __syncwarp();  // the buffer is restaged for the next item
  }
  if (cur >= 0) flush(a.Lq, slots + (size_t)(cur * W + warp) * a.Lq, m);
  __syncthreads();

  // a warp per candidate: the max over the warps' slots, then the sum
  for (int kc = warp; kc < kept; kc += W) {
    float mm[kMaxLqPerLane];
#pragma unroll
    for (int r = 0; r < kMaxLqPerLane; ++r) {
      const int qi = r * 32 + lane;
      mm[r] = kNeg;
      if (qi < a.Lq) {
        for (int w = 0; w < W; ++w) {
          mm[r] = fmaxf(mm[r], slots[(kc * W + w) * a.Lq + qi]);
        }
      }
    }
    const float score =
        query_sum(mm, a.q_valid + (size_t)b * a.Lq, a.Lq, lane);
    if (lane == 0) out[(size_t)b * a.C + grp.cand(kc)] = score;
  }
}

// Launches score_kernel on `stream` with tile_shape's block.
inline cudaError_t launch_scores(const TileArgs& a, const uint8_t* cmask,
                                 float* out, int B, cudaStream_t stream) {
  const TileShape t = tile_shape(a.Lq, a.d, a.nbits, (long)B * a.C);
  const size_t smem = tile_bytes(a.Lq, a.d, a.nbits, t);
  cudaError_t err = cudaFuncSetAttribute(
      score_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kMaxSmemBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.C + t.G - 1) / t.G, B);
  score_kernel<<<grid, t.W * 32, smem, stream>>>(a, cmask, t.G, t.P, out);
  return cudaGetLastError();
}

}  // namespace
}  // namespace rt
