// K2: build&merge (paper Fig. 14), the fused forward/backward frontier scan of
// one chunk, emitting the clean SLPF columns already packed into words.
//
// Replaces: src/repro/kernels/build.py, build_merge_chunk (_build_fwd_kernel and
// _merge_bwd_kernel), two sequential pallas_calls per chunk that share an
// aliased (k, lp) f32 M buffer: the forward scan writes M[t] = clamp(N[x_t] f),
// the backward scan with N^T ANDs beta_{t+1} into M[t] in place.
//
// Bound on this card: 2*k mat-vecs of lp^2 per chunk, a chain of dependent
// steps, against C*k ids in and C*k*W words out.  Per step the work is tiny, so
// the latency of one step (a few loads, a ballot, a barrier) bounds it, and the
// chunks running side by side are what fill the card.
//
// Design: one block per (batch row, chunk), one thread per state row (lp <= 1024,
// lp % 32 == 0).  The frontier lives in shared memory as W = lp/32 words, double
// buffered, one __syncthreads a step.  Forward: thread i computes
// (OR_w Nr[x_t][i][w] & v[w]) != 0 from the row-packed table, and the warp's
// __ballot_sync is word i/32 of the new frontier, which lane 0 also stores as
// word (t, i/32) of the output.  Backward from J^_{i+1}: lane 0 ANDs the packed
// beta_{t+1} into the word it wrote, then beta <- clamp(N[x_t]^T beta) from the
// column-packed table.  So the packed (k, W) columns are the only output, with
// no (k, lp) f32 buffer, in one launch where Pallas used two.  PAD steps
// (N = identity) are folded as the reference folds them.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void build_merge_kernel(const uint32_t* __restrict__ nr,
                                   const uint32_t* __restrict__ nc,
                                   const int32_t* __restrict__ ids,
                                   const float* __restrict__ entry_f,
                                   const float* __restrict__ entry_b,
                                   uint32_t* __restrict__ out, int k, int lp, int W) {
  extern __shared__ uint32_t sv[];   // [2][W] packed frontier
  const long long chunk = blockIdx.x;
  const int i = threadIdx.x;
  const int lane = i & 31;
  const int warp = i >> 5;
  const long long NW = static_cast<long long>(lp) * W;
  const int32_t* cid = ids + chunk * k;
  uint32_t* o = out + chunk * k * W;

  uint32_t word = __ballot_sync(0xffffffffu, entry_f[chunk * lp + i] != 0.f);
  if (lane == 0) sv[warp] = word;
  __syncthreads();

  int cur = 0;
  for (int t = 0; t < k; ++t) {                     // forward: fwd[t] = N[x_t] fwd
    const uint32_t* row = nr + cid[t] * NW + static_cast<long long>(i) * W;
    const uint32_t* v = sv + cur * W;
    uint32_t acc = 0;
    for (int w = 0; w < W; ++w) acc |= __ldg(row + w) & v[w];
    word = __ballot_sync(0xffffffffu, acc != 0);
    if (lane == 0) {
      sv[(cur ^ 1) * W + warp] = word;
      o[static_cast<long long>(t) * W + warp] = word;
    }
    cur ^= 1;
    __syncthreads();
  }

  word = __ballot_sync(0xffffffffu, entry_b[chunk * lp + i] != 0.f);
  if (lane == 0) sv[cur * W + warp] = word;         // beta_k = entry_b
  __syncthreads();

  for (int t = k - 1; t >= 0; --t) {                // backward + merge
    const uint32_t* b = sv + cur * W;               // beta_{t+1}
    if (lane == 0) o[static_cast<long long>(t) * W + warp] &= b[warp];
    const uint32_t* col = nc + cid[t] * NW + static_cast<long long>(i) * W;
    uint32_t acc = 0;
    for (int w = 0; w < W; ++w) acc |= __ldg(col + w) & b[w];
    word = __ballot_sync(0xffffffffu, acc != 0);
    if (lane == 0) sv[(cur ^ 1) * W + warp] = word;
    cur ^= 1;
    __syncthreads();
  }
}

}  // namespace

// nr, nc (A+1, lp, W) int32: N packed along its columns (row-packed) and along
// its rows (column-packed); ids (n_chunks, k) int32 in [0, A]; entry_f, entry_b
// (n_chunks, lp) f32 {0,1}; out (n_chunks, k, W) int32.  lp % 32 == 0 and
// lp <= 1024.  Returns the cudaError_t of the launch (0 on success).
extern "C" int repro_build_merge_packed(const uint32_t* nr, const uint32_t* nc,
                                        const int32_t* ids, const float* entry_f,
                                        const float* entry_b, uint32_t* out,
                                        int n_chunks, int k, int lp, void* stream) {
  if (n_chunks <= 0) return 0;
  if (lp <= 0 || lp % 32 != 0 || lp > 1024)
    return static_cast<int>(cudaErrorInvalidValue);
  const int W = lp / 32;
  build_merge_kernel<<<static_cast<unsigned>(n_chunks), lp, 2 * W * sizeof(uint32_t),
                       static_cast<cudaStream_t>(stream)>>>(nr, nc, ids, entry_f,
                                                            entry_b, out, k, lp, W);
  return static_cast<int>(cudaGetLastError());
}
