// The per-candidate arithmetic that the port's scoring kernels share.
//
// The rerank tail's tile body (rerank_tile.cuh, launched by
// decompress_maxsim.cu and fused_rerank.cu) and the MaxSim kernel over
// fp32 embeddings (maxsim.cu) each compute, per (query token, doc token)
// pair, one fmaf chain over j = 0 .. d-1, ascending, from 0.f, and per
// query token the max of those over the candidate's valid doc tokens,
// from the kNeg sentinel. Both then turn the maxima into the
// candidate's score with `query_sum` below, so on decoded embeddings
// MaxSim equals decompress+MaxSim bit for bit. Arithmetic is IEEE fp32
// on the CUDA cores; nothing is accumulated with atomics, so results are
// deterministic from run to run.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace rt {

constexpr float kNeg = -1e30f;       // masked-token sentinel (NEG)
constexpr int kMaxLqPerLane = 4;     // query tokens per lane: Lq <= 128
constexpr int kMaxBuckets = 16;      // 2^nbits for nbits <= 4

// Most dynamic shared memory one block may use on Hopper (_build.py's
// MAX_SMEM_BYTES; the wrappers refuse a launch that needs more). A
// launcher sets its kernel's cudaFuncAttributeMaxDynamicSharedMemorySize
// to this constant, never to its own launch's size: the attribute
// belongs to the kernel on a device and every host thread shares it, so
// a thread that lowered it between another thread's set and that
// thread's launch would fail that launch. The attribute only permits;
// it changes nothing a launch computes or the shared memory it uses.
constexpr int kMaxSmemBytes = 232448;

// Query rows in shared memory are d + 4 floats apart: float4 rows stay
// 16-byte aligned, and the 8 query tokens a quarter-warp of the rerank
// tile reads fall in distinct banks.
__host__ __device__ inline int q_stride(int d) { return d + 4; }

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
