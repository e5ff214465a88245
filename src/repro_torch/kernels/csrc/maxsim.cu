// Kernel 4: masked MaxSim over uncompressed fp32 doc embeddings.
//
// Replaces the TPU kernel `maxsim_pallas_batch`
// (src/repro/kernels/maxsim/maxsim.py:83) and, as a B=1 launch,
// `maxsim_pallas` (same file, :59).
//
// q (B, Lq, d) f32; docs (B, C, Ld, d) f32; valid (B, C, Ld) u8;
// q_valid (B, Lq) u8  ->  scores (B, C) f32.
//
// Bound on the H100: bytes at full lengths. Each valid doc token costs
// 2*Lq*d FLOPs (8,192 at Lq=32, d=128) against 4*d = 512 bytes read, 16
// FLOP per byte, below the ~20 FLOP/byte at which the card's fp32
// CUDA-core rate meets its memory rate: 590 MB of docs at B=32, C=200,
// Ld=180, d=128 take ~0.18 ms at 3.35 TB/s against ~0.14 ms for the
// 9.4 GFLOP. The design reads every valid token's row from device
// memory once (coalesced, one warp per candidate) and skips invalid
// tokens without reading them; the query stays in shared memory, so a
// row is paid once for all Lq dot products. It stages the raw row where
// decompress_maxsim decodes one, and shares the rest of the tile body
// (score_tile.cuh: token_max, query_sum), so on decoded embeddings the
// two kernels agree bit for bit. No tensor cores (IEEE fp32 is the
// contract), no TMA, no atomics: this first version is simple.
#include "score_tile.cuh"

namespace {

constexpr int kWarps = 8;  // candidates per block, one per warp

__global__ void __launch_bounds__(kWarps * 32)
maxsim_kernel(const float* __restrict__ q, const float* __restrict__ docs,
              const uint8_t* __restrict__ valid,
              const uint8_t* __restrict__ q_valid, float* __restrict__ out,
              int C, int Ld, int Lq, int d) {
  extern __shared__ __align__(16) float smem[];
  const int b = blockIdx.y;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const rt::TileSmem s = rt::carve_smem(smem, Lq, d, kWarps, warp);
  rt::load_query(q, b, Lq, d, s);
  __syncthreads();
  const int c = blockIdx.x * kWarps + warp;
  if (c >= C) return;

  const size_t tok0 = ((size_t)b * C + c) * Ld;
  float m[rt::kMaxLqPerLane];
  rt::init_max(m);
  for (int t = 0; t < Ld; ++t) {
    const size_t tok = tok0 + t;
    if (!valid[tok]) continue;  // the same for every lane of the warp
    const float* row = docs + tok * d;
    for (int j = lane; j < d; j += 32) s.emb[j] = row[j];
    __syncwarp();
    rt::token_max(s, Lq, d, lane, m);
    __syncwarp();  // the buffer is rewritten for the next token
  }
  const float score = rt::query_sum(m, q_valid + (size_t)b * Lq, Lq, lane);
  if (lane == 0) out[(size_t)b * C + c] = score;
}

}  // namespace

extern "C" size_t maxsim_smem_bytes(int Lq, int d) {
  return rt::tile_smem_floats(Lq, d, kWarps, 0) * sizeof(float);
}

// Launches on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int maxsim_launch(const void* q, const void* docs,
                             const void* valid, const void* q_valid,
                             void* out, int B, int C, int Ld, int Lq, int d,
                             void* stream) {
  const size_t smem = maxsim_smem_bytes(Lq, d);
  cudaError_t err = cudaFuncSetAttribute(
      maxsim_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((C + kWarps - 1) / kWarps, B);
  maxsim_kernel<<<grid, kWarps * 32, smem,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(docs),
      static_cast<const uint8_t*>(valid), static_cast<const uint8_t*>(q_valid),
      static_cast<float*>(out), C, Ld, Lq, d);
  return static_cast<int>(cudaGetLastError());
}
