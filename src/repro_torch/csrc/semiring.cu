// K3: batched Boolean (OR-AND) matrix product, out = min(A @ B, 1).
//
// Replaces: src/repro/kernels/semiring.py, semiring_matmul (_semiring_mm_kernel),
// a 128^3-tiled clamp(A @ B) with an fp32 accumulator.  In the port it is the
// `cuda` backend's compose and the combine and act of the join scan.
//
// Bound on this card: the join calls it on (b, lp, lp) x (b, lp, lp) stacks with
// lp = 64..288.  At lp = 64 a product is 2*64^3 = 0.5 Mop over 48 KiB of operands
// (~11 op/B), under the card's op-to-byte balance: bytes and launch latency bound
// it.  At lp = 288 it is ~64 op/B in f32, so the SIMT fp32 rate bounds it.
//
// Design: a classic shared-memory tiled GEMM.  A 64x64 output tile per block,
// 256 threads each holding a 4x4 register tile, K walked in steps of 16 through
// shared memory, fp32 accumulation (exact: sums of {0,1} stay far below 2^24).
// lp is a multiple of 32 but not of 64, and the join's mat-vecs have n = 1 or
// m = 1, so every edge is masked: out-of-range loads read 0, out-of-range
// stores are skipped.  Batch and tile indices are folded into blockIdx.x so
// the batch is not limited by gridDim.z.  Tensor cores are the next step.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 16;
constexpr int TM = 4;
constexpr int TN = 4;
constexpr int THREADS = (BM / TM) * (BN / TN);  // 256

__global__ void __launch_bounds__(THREADS)
semiring_mm_kernel(const float* __restrict__ a, const float* __restrict__ b,
                   float* __restrict__ out, int m, int n, int k,
                   int tiles_m, int tiles_n) {
  __shared__ float sa[BK][BM + 4];  // A tile, transposed: sa[kk][row]
  __shared__ float sb[BK][BN + 4];  // B tile: sb[kk][col]

  long long tile = blockIdx.x;
  const int tn = static_cast<int>(tile % tiles_n);
  tile /= tiles_n;
  const int tm = static_cast<int>(tile % tiles_m);
  const long long batch = tile / tiles_m;

  const float* A = a + batch * static_cast<long long>(m) * k;
  const float* B = b + batch * static_cast<long long>(k) * n;
  float* C = out + batch * static_cast<long long>(m) * n;

  const int row0 = tm * BM;
  const int col0 = tn * BN;
  const int tid = threadIdx.x;
  const int tr = tid / (BN / TN);
  const int tc = tid % (BN / TN);

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < k; k0 += BK) {
    for (int e = tid; e < BM * BK; e += THREADS) {
      const int r = e / BK, c = e % BK;
      const int gr = row0 + r, gc = k0 + c;
      sa[c][r] = (gr < m && gc < k) ? A[static_cast<long long>(gr) * k + gc] : 0.f;
    }
    for (int e = tid; e < BK * BN; e += THREADS) {
      const int r = e / BN, c = e % BN;
      const int gr = k0 + r, gc = col0 + c;
      sb[r][c] = (gr < k && gc < n) ? B[static_cast<long long>(gr) * n + gc] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float ra[TM], rb[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) ra[i] = sa[kk][tr * TM + i];
#pragma unroll
      for (int j = 0; j < TN; ++j) rb[j] = sb[kk][tc * TN + j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] += ra[i] * rb[j];
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gr = row0 + tr * TM + i;
    if (gr >= m) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gc = col0 + tc * TN + j;
      if (gc < n) C[static_cast<long long>(gr) * n + gc] = fminf(acc[i][j], 1.f);
    }
  }
}

}  // namespace

// a (batch, m, k), b (batch, k, n), out (batch, m, n): contiguous f32 on the
// device.  Returns the cudaError_t of the launch (0 on success).
extern "C" int repro_semiring_matmul(const float* a, const float* b, float* out,
                                     int batch, int m, int n, int k,
                                     void* stream) {
  if (batch <= 0 || m <= 0 || n <= 0) return 0;
  const int tiles_m = (m + BM - 1) / BM;
  const int tiles_n = (n + BN - 1) / BN;
  const long long blocks = static_cast<long long>(batch) * tiles_m * tiles_n;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  semiring_mm_kernel<<<static_cast<unsigned>(blocks), THREADS, 0,
                       static_cast<cudaStream_t>(stream)>>>(a, b, out, m, n, k,
                                                            tiles_m, tiles_n);
  return static_cast<int>(cudaGetLastError());
}
