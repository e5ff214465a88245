// Kernel 2: fused decompress + MaxSim + per-row top-k selection.
//
// Replaces the TPU kernel `fused_rerank_pallas_batch`
// (src/repro/kernels/fused_rerank/fused_rerank.py:144) and, as a B=1
// launch, `fused_rerank_pallas` (same file, :106).
//
// Inputs are those of decompress_maxsim plus cmask (B, C) u8; outputs
// the top-kk (score, candidate index) pairs of each row, kk <= C, in
// (score desc, index asc) order — the tie order of a stable descending
// sort. Masked candidates score -inf and keep their index.
//
// Bound on the H100: operations, as for decompress_maxsim (the top-k
// adds C^2 compares per row, 40,000 at C=200, next to 1.6 M FLOPs per
// candidate). The TPU kernel carries a running top-k across sequential
// grid steps; Hopper blocks run in parallel and in no order, so here
// one block owns one query row: its warps score the row's candidates
// into shared memory (C floats; the (B, C) score tensor never reaches
// device memory), then every thread ranks its candidates by counting
// the entries that beat them and writes those that rank below kk.
// Candidate scores come from the shared tile body, so this kernel
// equals decompress_maxsim + mask + stable sort bit for bit.
#include "score_tile.cuh"

namespace {

constexpr int kWarps = 16;  // warps sharing one query row

__global__ void __launch_bounds__(kWarps * 32)
fused_rerank_kernel(rt::TileArgs a, const uint8_t* __restrict__ cmask, int kk,
                    float* __restrict__ out_s, int32_t* __restrict__ out_i) {
  extern __shared__ __align__(16) float smem[];
  const int b = blockIdx.x;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const rt::TileSmem s = rt::carve_smem(smem, a.Lq, a.d, kWarps, warp);
  float* scores = s.extra;  // (C,)
  rt::load_row(a, b, s);
  __syncthreads();

  const float neg_inf = __int_as_float(static_cast<int>(0xff800000u));
  for (int c = warp; c < a.C; c += kWarps) {
    // a masked candidate would be set to -inf after scoring anyway
    const bool keep = cmask[(size_t)b * a.C + c] != 0;
    const float score = keep ? rt::score_candidate(a, b, c, s, lane) : neg_inf;
    if (lane == 0) scores[c] = score;
  }
  __syncthreads();

  for (int j = threadIdx.x; j < a.C; j += blockDim.x) {
    const float sj = scores[j];
    int rank = 0;
    for (int m = 0; m < a.C; ++m) {
      const float sm = scores[m];
      rank += (sm > sj) || (sm == sj && m < j);
    }
    if (rank < kk) {
      out_s[(size_t)b * kk + rank] = sj;
      out_i[(size_t)b * kk + rank] = j;
    }
  }
}

}  // namespace

extern "C" size_t fused_rerank_smem_bytes(int Lq, int d, int C) {
  // the score row is padded to 4 floats to keep the layout aligned
  return rt::tile_smem_floats(Lq, d, kWarps, (C + 3) / 4 * 4) * sizeof(float);
}

// Launches on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int fused_rerank_launch(
    const void* q, const void* packed, const void* cids, const void* valid,
    const void* cmask, const void* q_valid, const void* centroids,
    const void* bucket_weights, void* out_s, void* out_i, int B, int C, int Ld,
    int Lq, int d, int nbits, int kk, void* stream) {
  const rt::TileArgs a{static_cast<const float*>(q),
                       static_cast<const uint8_t*>(packed),
                       static_cast<const int32_t*>(cids),
                       static_cast<const uint8_t*>(valid),
                       static_cast<const uint8_t*>(q_valid),
                       static_cast<const float*>(centroids),
                       static_cast<const float*>(bucket_weights),
                       C, Ld, Lq, d, nbits};
  const size_t smem = fused_rerank_smem_bytes(Lq, d, C);
  cudaError_t err = cudaFuncSetAttribute(
      fused_rerank_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  fused_rerank_kernel<<<B, kWarps * 32, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      a, static_cast<const uint8_t*>(cmask), kk, static_cast<float*>(out_s),
      static_cast<int32_t*>(out_i));
  return static_cast<int>(cudaGetLastError());
}
