// K7: Mamba-2 SSD intra-chunk kernel: y and the chunk's state contribution.
//
// Replaces: src/repro/kernels/ssd_chunk.py, ssd_chunk (_ssd_chunk_kernel).
// Per flattened program p = (batch, chunk, head):
//   y   = (L o C B^T) xdt + exp(cs) o (C S_prev^T)        (q, hp)
//   S_c = (w o B)^T xdt,   w_j = exp(cs_last - cs_j)       (n, hp)
// with L_ij = exp(cs_i - cs_j) for i >= j, else 0.
//
// Bound on this card: zamba2-2.7b's prefill (batch 2 x 2048 tokens) calls it
// with P = 2 * 8 chunks * 80 heads = 1280, q = 256, hp = n = 64, xdt / B / C
// in bf16 and cs / S_prev / y / S_c in f32: ~247 MB moved (0.074 ms at
// 3.35 TB/s) against ~27 GFLOP (0.027 ms at 989 TFLOP/s bf16).  Bytes bound it.
//
// Design: the TPU kernel holds the whole (q, q) decay-masked product in VMEM.
// At q = 256 that tile is 256 KB in f32, above the 227 KB one block may use.
// So a program is split over blocks: block role y (one per 64-row tile of
// y) walks the column tiles j <= i of L o C B^T, 64 at a time, through shared
// memory, and then adds the inter-chunk term; block role S (one per program)
// computes S_c as its own reduction over j.  All three products run in full
// f32 on the SIMT units with 4-row register tiles (bf16 operands are widened
// on load): the plain version is f32 throughout, and its tolerance (2e-4)
// leaves no room for bf16 rounding of L o CB.  hp and n are multiples of 16
// up to 128.  The tensor cores (with an error analysis) are the next step.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int R = 64;       // rows of a y tile, and columns of a j tile
constexpr int THREADS = 256;
constexpr int MAXD = 128;   // largest hp and n
constexpr int MB = MAXD / 16;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

// (rows, cols) of a global (q, cols) slab starting at row r0 into a padded
// shared (R, cols + 1) f32 tile, zero beyond row q; each row scaled by
// scale[row] when scale is given.
template <typename T>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int r0, int q, int cols,
                                          const float* scale) {
  const int stride = cols + 1;
  for (int e = threadIdx.x; e < R * cols; e += THREADS) {
    const int r = e / cols, c = e % cols;
    float val = 0.f;
    if (r0 + r < q) {
      val = to_f32(src[static_cast<long long>(r0 + r) * cols + c]);
      if (scale != nullptr) val *= scale[r0 + r];
    }
    dst[r * stride + c] = val;
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
ssd_chunk_kernel(const T* __restrict__ xdt, const float* __restrict__ cs,
                 const T* __restrict__ B, const T* __restrict__ C,
                 const float* __restrict__ S_prev, float* __restrict__ y,
                 float* __restrict__ S_c, int q, int hp, int n) {
  extern __shared__ __align__(16) float smem[];
  const int n1 = n + 1, hp1 = hp + 1;
  float* s_cs = smem;                  // (q)   cs, then the S role's weights w
  float* s_a = s_cs + q;               // (R, n + 1)   C rows of the y tile
  float* s_b = s_a + R * n1;           // (R, n + 1)   B rows of the j tile
  float* s_x = s_b + R * n1;           // (R, hp + 1)  xdt rows of the j tile
  float* s_g = s_x + R * hp1;          // (R, R + 1)   L o C B^T tile; S_prev (hp, n + 1)

  const long long p = blockIdx.x;
  const T* X = xdt + p * q * hp;
  const T* Bp = B + p * q * n;
  const T* Cp = C + p * q * n;
  const float* csp = cs + p * q;
  const int tid = threadIdx.x;
  const int tr = tid / 16, tc = tid % 16;   // 16 x 16 thread grid
  const int hb = hp / 16;                    // output columns per thread: tc + 16 b
  const int n_row_tiles = (q + R - 1) / R;

  for (int i = tid; i < q; i += THREADS) s_cs[i] = csp[i];
  __syncthreads();

  if (static_cast<int>(blockIdx.y) == n_row_tiles) {
    // ---- role S: S_c[kk][c] = sum_j w_j B[j][kk] xdt[j][c] ----------------
    const float last = s_cs[q - 1];
    __syncthreads();
    for (int i = tid; i < q; i += THREADS) s_cs[i] = expf(last - s_cs[i]);
    const int nb = n / 16;                   // state rows per thread: tr + 16 a
    float acc[MB][MB];
#pragma unroll
    for (int a = 0; a < MB; ++a)
#pragma unroll
      for (int b = 0; b < MB; ++b) acc[a][b] = 0.f;
    for (int j0 = 0; j0 < q; j0 += R) {
      __syncthreads();
      load_tile(s_b, Bp, j0, q, n, s_cs);
      load_tile(s_x, X, j0, q, hp, nullptr);
      __syncthreads();
      for (int j = 0; j < R; ++j) {
        float bv[MB], xv[MB];
#pragma unroll
        for (int a = 0; a < MB; ++a) bv[a] = a < nb ? s_b[j * n1 + tr + 16 * a] : 0.f;
#pragma unroll
        for (int b = 0; b < MB; ++b) xv[b] = b < hb ? s_x[j * hp1 + tc + 16 * b] : 0.f;
#pragma unroll
        for (int a = 0; a < MB; ++a)
#pragma unroll
          for (int b = 0; b < MB; ++b) acc[a][b] = fmaf(bv[a], xv[b], acc[a][b]);
      }
    }
    float* out = S_c + p * n * hp;
#pragma unroll
    for (int a = 0; a < MB; ++a)
#pragma unroll
      for (int b = 0; b < MB; ++b)
        if (a < nb && b < hb) out[(tr + 16 * a) * hp + tc + 16 * b] = acc[a][b];
    return;
  }

  // ---- role y: rows i0 .. i0 + R - 1 --------------------------------------
  const int i0 = blockIdx.y * R;
  load_tile(s_a, Cp, i0, q, n, nullptr);
  float acc[4][MB];                          // rows tr*4 + a, columns tc + 16 b
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < MB; ++b) acc[a][b] = 0.f;

  for (int j0 = 0; j0 <= i0; j0 += R) {
    __syncthreads();
    load_tile(s_b, Bp, j0, q, n, nullptr);
    load_tile(s_x, X, j0, q, hp, nullptr);
    __syncthreads();
    // G = L o (C B^T) on this (R, R) tile: rows tr*4 + a, columns tc + 16 b
    float gacc[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) gacc[a][b] = 0.f;
    for (int kk = 0; kk < n; ++kk) {
      float cv[4], bv[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) cv[a] = s_a[(tr * 4 + a) * n1 + kk];
#pragma unroll
      for (int b = 0; b < 4; ++b) bv[b] = s_b[(tc + 16 * b) * n1 + kk];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) gacc[a][b] = fmaf(cv[a], bv[b], gacc[a][b]);
    }
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int i = i0 + tr * 4 + a, j = j0 + tc + 16 * b;
        const float gv = (i < q && j < q && i >= j) ? expf(s_cs[i] - s_cs[j]) * gacc[a][b] : 0.f;
        s_g[(tr * 4 + a) * (R + 1) + tc + 16 * b] = gv;
      }
    __syncthreads();
    for (int j = 0; j < R; ++j) {
      float gv[4], xv[MB];
#pragma unroll
      for (int a = 0; a < 4; ++a) gv[a] = s_g[(tr * 4 + a) * (R + 1) + j];
#pragma unroll
      for (int b = 0; b < MB; ++b) xv[b] = b < hb ? s_x[j * hp1 + tc + 16 * b] : 0.f;
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < MB; ++b) acc[a][b] = fmaf(gv[a], xv[b], acc[a][b]);
    }
  }

  // inter-chunk term: exp(cs_i) * sum_kk C[i][kk] S_prev[c][kk]
  __syncthreads();
  const float* Sp = S_prev + p * hp * n;
  for (int e = tid; e < hp * n; e += THREADS) s_g[(e / n) * n1 + e % n] = Sp[e];
  __syncthreads();
  float inter[4][MB];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < MB; ++b) inter[a][b] = 0.f;
  for (int kk = 0; kk < n; ++kk) {
    float cv[4], sv[MB];
#pragma unroll
    for (int a = 0; a < 4; ++a) cv[a] = s_a[(tr * 4 + a) * n1 + kk];
#pragma unroll
    for (int b = 0; b < MB; ++b) sv[b] = b < hb ? s_g[(tc + 16 * b) * n1 + kk] : 0.f;
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < MB; ++b) inter[a][b] = fmaf(cv[a], sv[b], inter[a][b]);
  }
  float* out = y + p * q * hp;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int i = i0 + tr * 4 + a;
    if (i >= q) continue;
    const float decay = expf(s_cs[i]);
#pragma unroll
    for (int b = 0; b < MB; ++b)
      if (b < hb) out[static_cast<long long>(i) * hp + tc + 16 * b] = acc[a][b] + decay * inter[a][b];
  }
}

template <typename T>
int launch(const void* xdt, const float* cs, const void* B, const void* C,
           const float* S_prev, float* y, float* S_c, int P, int q, int hp, int n,
           long long smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(ssd_chunk_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(P, (q + R - 1) / R + 1);
  ssd_chunk_kernel<T><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(xdt), cs, static_cast<const T*>(B), static_cast<const T*>(C),
      S_prev, y, S_c, q, hp, n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Dynamic shared memory one block needs at (q, hp, n).
extern "C" long long repro_ssd_chunk_smem_bytes(int q, int hp, int n) {
  const long long sg = static_cast<long long>(R) * (R + 1) > static_cast<long long>(hp) * (n + 1)
                           ? static_cast<long long>(R) * (R + 1)
                           : static_cast<long long>(hp) * (n + 1);
  return 4LL * (q + 2LL * R * (n + 1) + static_cast<long long>(R) * (hp + 1) + sg);
}

// xdt (P, q, hp), B and C (P, q, n) all f32 (dtype 0) or all bf16 (dtype 1);
// cs (P, q) f32, S_prev (P, hp, n) f32; outputs y (P, q, hp) and S_c (P, n, hp)
// f32.  Contiguous on the device; hp and n multiples of 16 up to 128.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int repro_ssd_chunk(const void* xdt, const float* cs, const void* B, const void* C,
                               const float* S_prev, float* y, float* S_c, int dtype, int P,
                               int q, int hp, int n, void* stream_ptr) {
  if (P <= 0 || q <= 0) return 0;
  if (hp % 16 || n % 16 || hp <= 0 || n <= 0 || hp > MAXD || n > MAXD || (q + R - 1) / R + 1 > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long smem = repro_ssd_chunk_smem_bytes(q, hp, n);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (dtype == 1)
    return launch<__nv_bfloat16>(xdt, cs, B, C, S_prev, y, S_c, P, q, hp, n, smem, stream);
  return launch<float>(xdt, cs, B, C, S_prev, y, S_c, P, q, hp, n, smem, stream);
}
