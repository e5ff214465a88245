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
// grid steps; Hopper blocks run in parallel and in no order, so the work
// is split in two launches on one stream:
// - scoring: decompress_maxsim's grid and tile body (rerank_tile.cuh),
//   one block per candidate or group of candidates, with cmask: a masked
//   candidate is not read and scores -inf. Scores go to a (B, C) f32
//   scratch that the wrapper allocates (25.6 KB at B=32, C=200), so the
//   fused tail's scores are the split tail's, bit for bit;
// - selection: one block per row loads its C scores into shared memory,
//   and each thread ranks its candidates by counting the entries that
//   beat them, writing those that rank below kk.
// The second launch costs one launch latency (a few microseconds) and a
// 25.6 KB round trip through L2; it needs no counter, so calls from
// several host threads cannot race on one.
#include "rerank_tile.cuh"

namespace {

constexpr int kSelectThreads = 256;

__global__ void __launch_bounds__(kSelectThreads)
select_topk_kernel(const float* __restrict__ scores, int C, int kk,
                   float* __restrict__ out_s, int32_t* __restrict__ out_i) {
  extern __shared__ __align__(16) float row[];
  const int b = blockIdx.x;
  for (int j = threadIdx.x; j < C; j += kSelectThreads) {
    row[j] = scores[(size_t)b * C + j];
  }
  __syncthreads();
  for (int j = threadIdx.x; j < C; j += kSelectThreads) {
    const float sj = row[j];
    int rank = 0;
    for (int m = 0; m < C; ++m) {
      const float sm = row[m];
      rank += (sm > sj) || (sm == sj && m < j);
    }
    if (rank < kk) {
      out_s[(size_t)b * kk + rank] = sj;
      out_i[(size_t)b * kk + rank] = j;
    }
  }
}

}  // namespace

// The larger of the two launches' shared memory.
extern "C" size_t fused_rerank_smem_bytes(int Lq, int d, int nbits, int C) {
  const size_t tile = rt::tile_bytes(Lq, d, nbits, rt::tile_shape(Lq, d, nbits, 1));
  const size_t select = (size_t)C * sizeof(float);
  return tile > select ? tile : select;
}

// Launches both kernels on `stream` and returns cudaGetLastError() (0 on
// success). `scratch` is (B, C) f32.
extern "C" int fused_rerank_launch(
    const void* q, const void* packed, const void* cids, const void* valid,
    const void* cmask, const void* q_valid, const void* centroids,
    const void* bucket_weights, void* scratch, void* out_s, void* out_i,
    int B, int C, int Ld, int Lq, int d, int nbits, int kk, void* stream) {
  const rt::TileArgs a{static_cast<const float*>(q),
                       static_cast<const uint8_t*>(packed),
                       static_cast<const int32_t*>(cids),
                       static_cast<const uint8_t*>(valid),
                       static_cast<const uint8_t*>(q_valid),
                       static_cast<const float*>(centroids),
                       static_cast<const float*>(bucket_weights),
                       C, Ld, Lq, d, nbits};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* sc = static_cast<float*>(scratch);
  cudaError_t err =
      rt::launch_scores(a, static_cast<const uint8_t*>(cmask), sc, B, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = (size_t)C * sizeof(float);
  err = cudaFuncSetAttribute(select_topk_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             rt::kMaxSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  select_topk_kernel<<<B, kSelectThreads, smem, s>>>(
      sc, C, kk, static_cast<float*>(out_s), static_cast<int32_t*>(out_i));
  return static_cast<int>(cudaGetLastError());
}
