// Shared tile body of the decompress+MaxSim and fused rerank kernels.
//
// Counterpart of `_score_tile` in the JAX package
// (src/repro/kernels/decompress_maxsim/decompress_maxsim.py:64), which
// both TPU kernels call. Both CUDA kernels score a candidate with
// `score_candidate` below, so per-candidate arithmetic — decode order,
// dot-product order over d, the per-query-token max and the ascending
// sum over query tokens — is identical in both, and the fused rerank
// tail equals the split tail bit for bit.
//
// One warp scores one candidate. For each valid doc token the warp
// decodes the token into a d-float shared-memory buffer
// (centroids[cid] + bucket_weights[code], the centroid row read from
// global memory through L2: a 131,072 x 128 table is 64 MiB and does
// not fit in shared memory), then lane i takes the dot product of query
// token i (held in shared memory) with it, sequentially over d with
// fmaf, and keeps its running max. Arithmetic is IEEE fp32 on the CUDA
// cores; nothing is accumulated with atomics, so results are
// deterministic from run to run.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace rt {

constexpr float kNeg = -1e30f;       // masked-token sentinel (NEG)
constexpr int kMaxLqPerLane = 4;     // query tokens per lane: Lq <= 128
constexpr int kMaxBuckets = 16;      // 2^nbits for nbits <= 4

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

// Shared-memory layout of one block, in floats: the query rows of batch
// row b (stride d + 4 keeps float4 rows 16-byte aligned and spreads
// lanes over banks), one decode buffer of d floats per warp, the bucket
// table, then `extra` floats for the caller.
__host__ __device__ inline int q_stride(int d) { return d + 4; }

__host__ __device__ inline size_t tile_smem_floats(int Lq, int d, int warps,
                                                   int extra) {
  return (size_t)Lq * q_stride(d) + (size_t)warps * d + kMaxBuckets + extra;
}

struct TileSmem {
  float* qs;
  float* emb;      // this warp's decode buffer
  float* bw;
  float* extra;
};

__device__ inline TileSmem carve_smem(float* smem, const TileArgs& a,
                                      int warps, int warp) {
  TileSmem s;
  s.qs = smem;
  float* emb_all = smem + (size_t)a.Lq * q_stride(a.d);
  s.emb = emb_all + (size_t)warp * a.d;
  s.bw = emb_all + (size_t)warps * a.d;
  s.extra = s.bw + kMaxBuckets;
  return s;
}

// Whole block: stage batch row b's query and the bucket table in shared
// memory. The caller synchronises the block afterwards.
__device__ inline void load_row(const TileArgs& a, int b, const TileSmem& s) {
  const int n = a.Lq * a.d;
  const float* qb = a.q + (size_t)b * n;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    s.qs[(i / a.d) * q_stride(a.d) + i % a.d] = qb[i];
  }
  if (threadIdx.x < (1 << a.nbits)) s.bw[threadIdx.x] = a.bucket_weights[threadIdx.x];
}

// One warp: the MaxSim score of candidate c of batch row b. Every lane
// returns the same value.
__device__ inline float score_candidate(const TileArgs& a, int b, int c,
                                        const TileSmem& s, int lane) {
  const int d = a.d, Lq = a.Lq, nbits = a.nbits;
  const int cpb = 8 / nbits;
  const int pd = d / cpb;
  const unsigned code_mask = (1u << nbits) - 1u;
  const size_t tok0 = ((size_t)b * a.C + c) * a.Ld;

  float m[kMaxLqPerLane];
#pragma unroll
  for (int r = 0; r < kMaxLqPerLane; ++r) m[r] = kNeg;

  for (int t = 0; t < a.Ld; ++t) {
    const size_t tok = tok0 + t;
    if (!a.valid[tok]) continue;  // the same for every lane of the warp
    const float* crow = a.centroids + (size_t)a.cids[tok] * d;
    const uint8_t* prow = a.packed + tok * pd;
    for (int j = lane; j < d; j += 32) {
      const unsigned code = (prow[j / cpb] >> ((j % cpb) * nbits)) & code_mask;
      s.emb[j] = crow[j] + s.bw[code];
    }
    __syncwarp();
    const float4* e4 = reinterpret_cast<const float4*>(s.emb);
#pragma unroll
    for (int r = 0; r < kMaxLqPerLane; ++r) {
      const int qi = r * 32 + lane;
      if (qi < Lq) {
        const float4* q4 =
            reinterpret_cast<const float4*>(s.qs + (size_t)qi * q_stride(d));
        float acc = 0.f;
        for (int j = 0; j < d / 4; ++j) {
          const float4 x = q4[j];
          const float4 y = e4[j];
          acc = fmaf(x.x, y.x, acc);
          acc = fmaf(x.y, y.y, acc);
          acc = fmaf(x.z, y.z, acc);
          acc = fmaf(x.w, y.w, acc);
        }
        m[r] = fmaxf(m[r], acc);
      }
    }
    __syncwarp();  // the buffer is rewritten for the next token
  }

  // a query token with no valid doc token scores 0, a padded query
  // token contributes 0; the sum runs over query tokens in ascending
  // order
  float total = 0.f;
#pragma unroll
  for (int r = 0; r < kMaxLqPerLane; ++r) {
    if (r * 32 >= Lq) break;
    const int qi = r * 32 + lane;
    float v = 0.f;
    if (qi < Lq) {
      v = m[r] <= kNeg * 0.5f ? 0.f : m[r];
      v = v * (a.q_valid[(size_t)b * Lq + qi] ? 1.f : 0.f);
    }
    const int n = min(32, Lq - r * 32);
    for (int src = 0; src < n; ++src) total += __shfl_sync(0xffffffffu, v, src);
  }
  return total;
}

}  // namespace rt
