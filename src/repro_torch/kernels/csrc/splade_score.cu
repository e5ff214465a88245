// Kernel 3: SPLADE stage-1 impact scoring over padded postings.
//
// Replaces the TPU kernel `splade_block_pallas_batch`
// (src/repro/kernels/splade_score/splade_score.py:97) and, as a B=1
// launch, `splade_block_pallas` (same file, :71).
//
// row_pids (R, max_df) i32, -1 padded; row_imps (R, max_df) u8 or f32;
// rows (B, Qt) i32: the posting row that query b's term slot t reads
// (-1: an empty slot); w (B, Qt) f32: that slot's weight, already
// scaled by the index's quantum  ->  scores (B, n_docs) f32 with
//
//     scores[b, p] = sum of w[b, t] * imp over the entries (t, j) with
//                    rows[b, t] >= 0, w[b, t] > 0, row_pids[...] == p,
//
// added in (term slot ascending, posting slot ascending) order from
// +0.0. That is the order of the host CSR scorer
// (SpladeIndex.score_batch_host, one query-major np.add.at), so with
// untruncated postings a row of this kernel equals the host's bit for
// bit, and which candidate reaches the 200th place of stage 1 does not
// depend on the backend (quantised impacts tie often).
//
// The FMA trap: nvcc contracts a*b + c into one fused multiply-add by
// default, which rounds once where the host rounds twice. The product
// and the sum are therefore written with __fmul_rn and __fadd_rn,
// which the compiler never contracts.
//
// The TPU kernel turns the scatter into a one-hot matmul on the MXU;
// none of that is carried over. Here one block owns one query row b and
// a block of kBlockD docs; each thread owns the doc slots congruent to
// its index mod kThreads, so no two threads ever add into one score and
// no atomics are needed. The block streams the query's entries through
// shared memory in chunks of kThreads, in (term slot, posting slot)
// order: each thread reads one entry, those that fall in the block are
// compacted in order (warp ballots and a block prefix), and every
// thread then walks the compacted list and adds the entries of its own
// slots, in list order. The whole (B, n_docs) row is written, zeros
// included.
//
// Bound on the H100: bytes — the postings of the queried terms read
// once plus 4*B*n_docs bytes of scores written; there is ~1 FLOP per
// 5 bytes. This first design reads each query's entries once per doc
// block (B * n_blocks * Qt * max_df entries, padding included, mostly
// from L2), which is what it costs over the bound; a later version can
// binary-search each pid-sorted row for the block's range instead.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;           // one entry per thread per chunk
constexpr int kWarps = kThreads / 32;
constexpr int kBlockD = 8192;           // docs per block: 32 KB of sums

template <typename Imp>
__global__ void __launch_bounds__(kThreads)
splade_score_kernel(const int32_t* __restrict__ row_pids,
                    const Imp* __restrict__ row_imps,
                    const int32_t* __restrict__ rows,
                    const float* __restrict__ w, float* __restrict__ out,
                    int Qt, int max_df, int n_docs) {
  __shared__ float acc[kBlockD];
  __shared__ int list_slot[kThreads];
  __shared__ float list_val[kThreads];
  __shared__ int warp_hits[kWarps];

  const int b = blockIdx.y;
  const int lo = blockIdx.x * kBlockD;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;

  // only the owner thread ever touches a slot, so no barrier is needed
  // between this and its first add
  for (int slot = tid; slot < kBlockD; slot += kThreads) acc[slot] = 0.f;

  const int E = Qt * max_df;
  const int32_t* rows_b = rows + (size_t)b * Qt;
  const float* w_b = w + (size_t)b * Qt;
  for (int base = 0; base < E; base += kThreads) {
    const int e = base + tid;
    bool hit = false;
    int slot = 0;
    float val = 0.f;
    if (e < E) {
      const int t = e / max_df;
      const int j = e - t * max_df;
      const int row = rows_b[t];
      const float wt = w_b[t];
      if (row >= 0 && wt > 0.f) {
        const size_t at = (size_t)row * max_df + j;
        const int pid = row_pids[at];
        if (pid >= lo && pid < lo + kBlockD && pid < n_docs) {
          hit = true;
          slot = pid - lo;
          val = __fmul_rn(wt, static_cast<float>(row_imps[at]));
        }
      }
    }
    // order-preserving compaction of this chunk's hits
    const unsigned ballot = __ballot_sync(0xffffffffu, hit);
    if (lane == 0) warp_hits[warp] = __popc(ballot);
    __syncthreads();
    int before = 0, total = 0;
#pragma unroll
    for (int k = 0; k < kWarps; ++k) {
      const int n = warp_hits[k];
      before += k < warp ? n : 0;
      total += n;
    }
    if (hit) {
      const int pos = before + __popc(ballot & ((1u << lane) - 1u));
      list_slot[pos] = slot;
      list_val[pos] = val;
    }
    __syncthreads();
    for (int i = 0; i < total; ++i) {
      const int s = list_slot[i];
      if (s % kThreads == tid) acc[s] = __fadd_rn(acc[s], list_val[i]);
    }
    __syncthreads();  // the list and the counts are rewritten next
  }

  float* out_b = out + (size_t)b * n_docs;
  for (int slot = tid; slot < kBlockD; slot += kThreads) {
    const int p = lo + slot;
    if (p < n_docs) out_b[p] = acc[slot];
  }
}

}  // namespace

extern "C" int splade_score_block_docs() { return kBlockD; }

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// imps_u8 selects the impact type: 1 for u8 (quantised), 0 for f32.
extern "C" int splade_score_launch(const void* row_pids, const void* row_imps,
                                   int imps_u8, const void* rows,
                                   const void* w, void* out, int B, int Qt,
                                   int max_df, int n_docs, void* stream) {
  const dim3 grid((n_docs + kBlockD - 1) / kBlockD, B);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int32_t* pids = static_cast<const int32_t*>(row_pids);
  const int32_t* r = static_cast<const int32_t*>(rows);
  const float* wt = static_cast<const float*>(w);
  float* o = static_cast<float*>(out);
  if (imps_u8) {
    splade_score_kernel<uint8_t><<<grid, kThreads, 0, st>>>(
        pids, static_cast<const uint8_t*>(row_imps), r, wt, o, Qt, max_df,
        n_docs);
  } else {
    splade_score_kernel<float><<<grid, kThreads, 0, st>>>(
        pids, static_cast<const float*>(row_imps), r, wt, o, Qt, max_df,
        n_docs);
  }
  return static_cast<int>(cudaGetLastError());
}
