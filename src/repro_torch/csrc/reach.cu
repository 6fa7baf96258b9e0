// K1: reach, the per-chunk Boolean chain product P = N[x_k] (x) ... (x) N[x_1].
//
// Replaces: src/repro/kernels/reach.py, reach_chunk_product (_reach_kernel), a
// sequential grid over the chunk's k characters that holds the (lp, lp) running
// product in VMEM and multiplies it on the MXU, one chunk per call.
//
// Bound on this card: the work is C*k products of lp^3 multiply-adds, against
// C*k ids in and C*lp^2 floats out, so operations bound it, and the k steps of a
// chunk are a chain that cannot be split.  Blocks run in parallel and in no
// order, so the TPU's sequential grid does not carry over.
//
// Design: under left multiplication P' = N[x] P every column of P evolves on its
// own.  So the grid is (chunks) x (lp / 32 column strips), and each block walks
// its chunk's k class ids itself, keeping only its 32-column strip.  The strip
// is held as bits (column j = W = lp/32 words over the rows) and N as row-packed
// words, so one step is P'[i][j] = (OR_w Nr[x][i][w] & P[j][w]) != 0: lp*32*W
// word operations instead of lp^2*32 multiply-adds.  One warp produces one word
// of one column (lane = row), gathered with __ballot_sync.  N[x_{t+1}] is copied
// into shared memory while step t computes (double buffering of both N and the
// strip), so each step costs one __syncthreads.  The table lives in L2 (TRAFFIC
// 19*64*2 words, e125 4*288*9 words).  The strip is written out as f32 {0,1},
// bit for bit the product of the plain version.  PAD steps (N = identity) are
// folded like any other step.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int STRIP = 32;
constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;

__global__ void __launch_bounds__(THREADS)
reach_kernel(const uint32_t* __restrict__ nr, const int32_t* __restrict__ ids,
             float* __restrict__ out, int k, int lp, int W) {
  extern __shared__ uint32_t smem[];
  const int NW = lp * W;
  uint32_t* sN = smem;               // [2][lp * W]    row-packed N[x_t]
  uint32_t* sP = smem + 2 * NW;      // [2][STRIP * W] bit columns of the strip

  const long long chunk = blockIdx.x;
  const int j0 = blockIdx.y * STRIP;
  const int32_t* cid = ids + chunk * k;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  for (int e = tid; e < STRIP * W; e += THREADS) {   // identity strip
    const int j = j0 + e / W;
    const int w = e % W;
    sP[e] = (w == (j >> 5)) ? (1u << (j & 31)) : 0u;
  }
  if (k > 0) {
    const uint32_t* src = nr + static_cast<long long>(cid[0]) * NW;
    for (int e = tid; e < NW; e += THREADS) sN[e] = __ldg(src + e);
  }
  __syncthreads();

  for (int t = 0; t < k; ++t) {
    const int cur = t & 1;
    const uint32_t* n_cur = sN + cur * NW;
    const uint32_t* p_cur = sP + cur * STRIP * W;
    uint32_t* p_nxt = sP + (cur ^ 1) * STRIP * W;
    if (t + 1 < k) {
      const uint32_t* src = nr + static_cast<long long>(cid[t + 1]) * NW;
      uint32_t* dst = sN + (cur ^ 1) * NW;
      for (int e = tid; e < NW; e += THREADS) dst[e] = __ldg(src + e);
    }
    for (int task = warp; task < STRIP * W; task += WARPS) {
      const int jj = task / W;
      const int wo = task % W;
      const uint32_t* nrow = n_cur + (wo * 32 + lane) * W;
      const uint32_t* pcol = p_cur + jj * W;
      uint32_t acc = 0;
      for (int w = 0; w < W; ++w) acc |= nrow[w] & pcol[w];
      const uint32_t word = __ballot_sync(0xffffffffu, acc != 0);
      if (lane == 0) p_nxt[task] = word;   // task = jj * W + wo
    }
    __syncthreads();
  }

  const uint32_t* p_fin = sP + (k & 1) * STRIP * W;
  float* o = out + chunk * lp * lp;
  for (int e = tid; e < lp * STRIP; e += THREADS) {
    const int i = e / STRIP;
    const int jj = e % STRIP;
    const uint32_t bit = (p_fin[jj * W + (i >> 5)] >> (i & 31)) & 1u;
    o[static_cast<long long>(i) * lp + j0 + jj] = bit ? 1.f : 0.f;
  }
}

}  // namespace

// Shared memory one block needs at this lp (bytes); above 232448 the kernel
// cannot launch on Hopper.
extern "C" long long repro_reach_smem_bytes(int lp) {
  const long long W = lp / 32;
  return (2LL * lp * W + 2LL * STRIP * W) * 4;
}

// nr (A+1, lp, W) int32 row-packed N; ids (n_chunks, k) int32 class ids in
// [0, A]; out (n_chunks, lp, lp) f32.  lp % 32 == 0.  Returns the cudaError_t
// of the launch (0 on success).
extern "C" int repro_reach_products(const uint32_t* nr, const int32_t* ids,
                                    float* out, int n_chunks, int k, int lp,
                                    void* stream) {
  if (n_chunks <= 0) return 0;
  if (lp <= 0 || lp % 32 != 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long smem = repro_reach_smem_bytes(lp);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        reach_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(static_cast<unsigned>(n_chunks), static_cast<unsigned>(lp / STRIP));
  reach_kernel<<<grid, THREADS, static_cast<size_t>(smem),
                 static_cast<cudaStream_t>(stream)>>>(nr, ids, out, k, lp, lp / 32);
  return static_cast<int>(cudaGetLastError());
}
