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
// which the card's fp32 CUDA-core rate meets its memory rate. Each
// valid token also gathers its 512-byte centroid row from a table that
// does not fit in L2 (64 MiB at K=131,072), a second limit behind the
// FLOPs. The design (rerank_tile.cuh): one block per candidate, or per
// group of up to 4 when the batch fills the card, so a single query
// spreads over C blocks; the block's 8 warps work independently, each on
// windows of 16 token positions: it gathers the valid tokens' rows with
// cp.async, decodes them in its own shared buffer and scores them in
// 4 x 4 register tiles (2 FMAs per float read from shared memory, 16
// independent chains per thread), so the SM's 16 warps hide one
// another's gathers. The decoded embedding never reaches device memory.
// No tensor cores (IEEE fp32 is the contract), no atomics.
#include "rerank_tile.cuh"

extern "C" size_t decompress_maxsim_smem_bytes(int Lq, int d, int nbits) {
  return rt::tile_bytes(Lq, d, nbits, rt::tile_shape(Lq, d, nbits, 1));
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
  return static_cast<int>(rt::launch_scores(
      a, nullptr, static_cast<float*>(out), B,
      static_cast<cudaStream_t>(stream)));
}

extern "C" const char* rt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
