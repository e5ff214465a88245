// Shared MaxSim arithmetic of the port's tile kernels.
//
// The MaxSim kernel over fp32 embeddings (maxsim.cu) runs `token_max`
// and `query_sum` as they are below: one warp scores one candidate,
// stages each valid doc token in a d-float shared-memory buffer, and
// lane i takes the dot product of query token i (held in shared memory)
// with it, sequentially over d with fmaf, keeping its running max.
//
// The rerank tail's kernels (decompress_maxsim.cu, fused_rerank.cu) run
// the register-tiled body of rerank_tile.cuh, which keeps this file's
// per-pair arithmetic — the fmaf chain over j ascending from 0.f, the
// max from kNeg, `query_sum` itself — so on decoded embeddings MaxSim
// equals decompress+MaxSim bit for bit. Arithmetic is IEEE fp32 on the
// CUDA cores; nothing is accumulated with atomics, so results are
// deterministic from run to run.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace rt {

constexpr float kNeg = -1e30f;       // masked-token sentinel (NEG)
constexpr int kMaxLqPerLane = 4;     // query tokens per lane: Lq <= 128
constexpr int kMaxBuckets = 16;      // 2^nbits for nbits <= 4

// Shared-memory layout of one block, in floats: the query rows of batch
// row b (stride d + 4 keeps float4 rows 16-byte aligned and spreads
// lanes over banks), one token buffer of d floats per warp, the bucket
// table, then `extra` floats for the caller.
__host__ __device__ inline int q_stride(int d) { return d + 4; }

__host__ __device__ inline size_t tile_smem_floats(int Lq, int d, int warps,
                                                   int extra) {
  return (size_t)Lq * q_stride(d) + (size_t)warps * d + kMaxBuckets + extra;
}

struct TileSmem {
  float* qs;
  float* emb;      // this warp's token buffer
  float* bw;
  float* extra;
};

__device__ inline TileSmem carve_smem(float* smem, int Lq, int d, int warps,
                                      int warp) {
  TileSmem s;
  s.qs = smem;
  float* emb_all = smem + (size_t)Lq * q_stride(d);
  s.emb = emb_all + (size_t)warp * d;
  s.bw = emb_all + (size_t)warps * d;
  s.extra = s.bw + kMaxBuckets;
  return s;
}

// Whole block: stage batch row b's query (B, Lq, d) in shared memory.
// The caller synchronises the block afterwards.
__device__ inline void load_query(const float* q, int b, int Lq, int d,
                                  const TileSmem& s) {
  const int n = Lq * d;
  const float* qb = q + (size_t)b * n;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    s.qs[(i / d) * q_stride(d) + i % d] = qb[i];
  }
}

// The MaxSim part of the tile body, shared by every kernel that scores
// a candidate: `token_max` folds one doc token, already staged in the
// warp's buffer s.emb, into each lane's running maxima; `query_sum`
// turns the maxima into the candidate's score.

__device__ inline void init_max(float (&m)[kMaxLqPerLane]) {
#pragma unroll
  for (int r = 0; r < kMaxLqPerLane; ++r) m[r] = kNeg;
}

// Lane i takes the dot product of query token i (and i + 32, ...) with
// the staged token, sequentially over d with fmaf, and keeps the max.
__device__ inline void token_max(const TileSmem& s, int Lq, int d, int lane,
                                 float (&m)[kMaxLqPerLane]) {
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
}

// A query token with no valid doc token scores 0, a padded query token
// (q_valid_row[qi] == 0) contributes 0; the sum runs over query tokens
// in ascending order. Every lane returns the same value.
__device__ inline float query_sum(const float (&m)[kMaxLqPerLane],
                                  const uint8_t* q_valid_row, int Lq,
                                  int lane) {
  float total = 0.f;
#pragma unroll
  for (int r = 0; r < kMaxLqPerLane; ++r) {
    if (r * 32 >= Lq) break;
    const int qi = r * 32 + lane;
    float v = 0.f;
    if (qi < Lq) {
      v = m[r] <= kNeg * 0.5f ? 0.f : m[r];
      v = v * (q_valid_row[qi] ? 1.f : 0.f);
    }
    const int n = min(32, Lq - r * 32);
    for (int src = 0; src < n; ++src) total += __shfl_sync(0xffffffffu, v, src);
  }
  return total;
}

}  // namespace rt
