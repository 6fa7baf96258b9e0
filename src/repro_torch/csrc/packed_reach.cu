// K4 packed reach and K5 sparse reach: the chunk fold on packed bit words.
//
// Replaces: src/repro/kernels/packed_reach.py, packed_reach_chunk_product
// (_packed_reach_kernel), and src/repro/kernels/sparse_reach.py,
// sparse_reach_rows (_sparse_reach_kernel).  Each is a sequential grid over a
// chunk's k characters that keeps the running rows in VMEM and, per step,
// ORs together the packed rows of N[x_t] selected by each row's bits, one
// chunk per call.
//
// The fold: rows R (n_rows, W = lp/32) of packed target sets (bit b of word w
// is target 32*w + b); per character x,
//     R'[j] = OR over the set bits k of R[j] of Np[x][k],
// where row k of Np[x] is the packed target set of source k (the reference's
// pack_transition_table orientation, i.e. N transposed, not K1's row-packed
// N).  K4 seeds R with the packed identity over n_rows = lp rows, so R ends
// as the chunk product; K5 seeds R from R0, the S gathered feasible-start
// rows of the sparse backend.  Both share one kernel.
//
// Bound on this card: per chunk the k steps are a chain that cannot be split,
// and a step's work is data-dependent (popcount(R[j]) table rows of W words
// for each row), against ids, one (A+1, lp, W) table and the rows in and out
// in device memory.  So operations and step latency bound it, not bytes.
//
// Design: every row evolves on its own, so the grid is (chunks) x (row
// groups) and nothing crosses blocks.  Each block reads its chunk's class ids
// itself (Hopper has no scalar prefetch).  A thread owns one output word v of
// one row j: it walks the set bits of R[j] (read from shared memory, the same
// words for the W threads of a row) and ORs word v of the selected table rows,
// so the W threads of a row read W consecutive words.  N[x_{t+1}] is copied
// into shared memory while step t computes, and the rows are double-buffered
// too, so each step costs one __syncthreads (as K1 does).  PAD steps (the
// identity) are folded like any other step.
//
// Limits, checked by the launchers in kernels/packed_reach.py and
// kernels/sparse_reach.py: lp % 32 == 0 and 8 * lp * W + 8 * (rows per block)
// * W bytes of shared memory <= 232448, which holds for lp <= 960; K5 needs
// S <= lp.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

int rows_per_block(int W, int n_rows) {
  int rpb = THREADS / W;
  if (rpb > n_rows) rpb = n_rows;
  return rpb < 1 ? 1 : rpb;
}

__global__ void __launch_bounds__(THREADS)
packed_fold_kernel(const uint32_t* __restrict__ np, const int32_t* __restrict__ ids,
                   const uint32_t* __restrict__ r0, uint32_t* __restrict__ out,
                   int k, int lp, int W, int n_rows, int rpb) {
  extern __shared__ uint32_t smem[];
  const int NW = lp * W;
  const int RW = rpb * W;
  uint32_t* sN = smem;             // [2][lp * W]   packed rows of N[x_t]
  uint32_t* sR = smem + 2 * NW;    // [2][rpb * W]  this block's running rows

  const long long chunk = blockIdx.x;
  const int32_t* cid = ids + chunk * k;
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;  // rpb * W
  const int r = tid / W;
  const int v = tid - r * W;
  const int row = blockIdx.y * rpb + r;
  const bool live = row < n_rows;
  const long long at = (chunk * n_rows + row) * W + v;

  uint32_t seed = 0;
  if (live) {
    if (r0 != nullptr) {
      seed = r0[at];
    } else {
      seed = (v == (row >> 5)) ? (1u << (row & 31)) : 0u;
    }
  }
  sR[tid] = seed;
  if (k > 0) {
    const uint32_t* src = np + static_cast<long long>(cid[0]) * NW;
    for (int e = tid; e < NW; e += nthreads) sN[e] = __ldg(src + e);
  }
  __syncthreads();

  for (int t = 0; t < k; ++t) {
    const int cur = t & 1;
    const uint32_t* n_cur = sN + cur * NW;
    const uint32_t* r_cur = sR + cur * RW + r * W;
    if (t + 1 < k) {
      const uint32_t* src = np + static_cast<long long>(cid[t + 1]) * NW;
      uint32_t* dst = sN + (cur ^ 1) * NW;
      for (int e = tid; e < NW; e += nthreads) dst[e] = __ldg(src + e);
    }
    uint32_t acc = 0;
    for (int w = 0; w < W; ++w) {
      uint32_t bits = r_cur[w];
      while (bits) {
        const int b = __ffs(bits) - 1;
        bits &= bits - 1;
        acc |= n_cur[(w * 32 + b) * W + v];
      }
    }
    sR[(cur ^ 1) * RW + tid] = acc;
    __syncthreads();
  }

  if (live) out[at] = sR[(k & 1) * RW + tid];
}

}  // namespace

// Shared memory one block needs for lp states and n_rows rows (bytes); above
// 232448 the kernel cannot launch on Hopper.
extern "C" long long repro_packed_fold_smem_bytes(int lp, int n_rows) {
  const int W = lp / 32;
  if (W < 1) return 0;
  const long long rpb = rows_per_block(W, n_rows);
  return (2LL * lp * W + 2LL * rpb * W) * 4;
}

namespace {

int launch_fold(const uint32_t* np, const int32_t* ids, const uint32_t* r0,
                uint32_t* out, int n_chunks, int k, int lp, int n_rows,
                void* stream) {
  if (n_chunks <= 0 || n_rows <= 0) return 0;
  if (lp <= 0 || lp % 32 != 0 || k < 0) return static_cast<int>(cudaErrorInvalidValue);
  const int W = lp / 32;
  if (W > THREADS) return static_cast<int>(cudaErrorInvalidValue);
  const int rpb = rows_per_block(W, n_rows);
  const long long smem = repro_packed_fold_smem_bytes(lp, n_rows);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        packed_fold_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(static_cast<unsigned>(n_chunks),
                  static_cast<unsigned>((n_rows + rpb - 1) / rpb));
  packed_fold_kernel<<<grid, rpb * W, static_cast<size_t>(smem),
                       static_cast<cudaStream_t>(stream)>>>(np, ids, r0, out, k, lp, W,
                                                            n_rows, rpb);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K4.  np (A+1, lp, W) int32 packed transition rows; ids (n_chunks, k) int32
// class ids in [0, A]; out (n_chunks, lp, W) int32 chunk products.  Returns
// the cudaError_t of the launch (0 on success).
extern "C" int repro_packed_reach_products(const uint32_t* np, const int32_t* ids,
                                           uint32_t* out, int n_chunks, int k, int lp,
                                           void* stream) {
  return launch_fold(np, ids, nullptr, out, n_chunks, k, lp, lp, stream);
}

// K5.  As K4, but the fold starts from r0 (n_chunks, S, W) int32 and out is
// (n_chunks, S, W) int32.
extern "C" int repro_sparse_reach_rows(const uint32_t* np, const int32_t* ids,
                                       const uint32_t* r0, uint32_t* out, int n_chunks,
                                       int k, int lp, int S, void* stream) {
  return launch_fold(np, ids, r0, out, n_chunks, k, lp, S, stream);
}
