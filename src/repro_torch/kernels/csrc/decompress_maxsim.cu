// Kernel 1: fused residual decompression + masked MaxSim scores.
//
// Replaces the TPU kernel `decompress_maxsim_pallas_batch`
// (src/repro/kernels/decompress_maxsim/decompress_maxsim.py:132) and,
// as a B=1 launch, `decompress_maxsim_pallas` (same file, :103).
//
// q (B, Lq, d) f32; packed (B, C, Ld, d*nbits/8) u8; cids (B, C, Ld) i32;
// valid (B, C, Ld) u8; q_valid (B, Lq) u8; centroids (K, d) f32;
// bucket_weights (2^nbits) f32  ->  scores (B, C) f32.
//
// Bound on the H100: operations. Each valid doc token costs 2*Lq*d fp32
// FLOPs (8,192 at Lq=32, d=128) against 69 bytes of packed codes, id
// and valid flag, ~120 FLOP per byte, far above the ~20 FLOP/byte at
// which the card's fp32 CUDA-core rate meets its memory rate. The
// design keeps the decoded embedding out of device memory (decoded in
// shared memory, one token at a time, per warp) and gives every lane a
// query token, so a token's decode is paid once for all Lq dot
// products. No tensor cores (IEEE fp32 is the contract), no TMA: this
// first version is simple, one warp per candidate.
#include "score_tile.cuh"

namespace {

constexpr int kWarps = 8;  // candidates per block, one per warp

__global__ void __launch_bounds__(kWarps * 32)
decompress_maxsim_kernel(rt::TileArgs a, float* __restrict__ out) {
  extern __shared__ __align__(16) float smem[];
  const int b = blockIdx.y;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const rt::TileSmem s = rt::carve_smem(smem, a.Lq, a.d, kWarps, warp);
  rt::load_row(a, b, s);
  __syncthreads();
  const int c = blockIdx.x * kWarps + warp;
  if (c >= a.C) return;
  const float score = rt::score_candidate(a, b, c, s, lane);
  if (lane == 0) out[(size_t)b * a.C + c] = score;
}

}  // namespace

extern "C" size_t decompress_maxsim_smem_bytes(int Lq, int d) {
  return rt::tile_smem_floats(Lq, d, kWarps, 0) * sizeof(float);
}

// Launches on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int decompress_maxsim_launch(
    const void* q, const void* packed, const void* cids, const void* valid,
    const void* q_valid, const void* centroids, const void* bucket_weights,
    void* out, int B, int C, int Ld, int Lq, int d, int nbits, void* stream) {
  const rt::TileArgs a{static_cast<const float*>(q),
                       static_cast<const uint8_t*>(packed),
                       static_cast<const int32_t*>(cids),
                       static_cast<const uint8_t*>(valid),
                       static_cast<const uint8_t*>(q_valid),
                       static_cast<const float*>(centroids),
                       static_cast<const float*>(bucket_weights),
                       C, Ld, Lq, d, nbits};
  const size_t smem = decompress_maxsim_smem_bytes(Lq, d);
  cudaError_t err = cudaFuncSetAttribute(
      decompress_maxsim_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((C + kWarps - 1) / kWarps, B);
  decompress_maxsim_kernel<<<grid, kWarps * 32, smem,
                             static_cast<cudaStream_t>(stream)>>>(
      a, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* rt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
