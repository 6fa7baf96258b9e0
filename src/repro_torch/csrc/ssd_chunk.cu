// K7: Mamba-2 SSD intra-chunk kernel: y and the chunk's state contribution.
//
// Replaces: src/repro/kernels/ssd_chunk.py, ssd_chunk (_ssd_chunk_kernel).
// Per flattened program p = (batch, chunk, head):
//   y   = (L o C B^T) xdt + exp(cs) o (C S_prev^T)        (q, hp)
//   S_c = (w o B)^T xdt,   w_j = exp(cs_last - cs_j)       (n, hp)
// with L_ij = exp(cs_i - cs_j) for i >= j, else 0.  A launch computes y, S_c
// or both (`outputs`): the two-pass SSD asks for S_c alone in its reach pass
// and for y alone in its build pass, and a launch for S_c alone reads
// neither C nor S_prev.
//
// Bound on this card: zamba2-2.7b's prefill (batch 2 x 2048 tokens) calls it
// with P = 2 * 8 chunks * 80 heads = 1280, q = 256, hp = n = 64, xdt / B / C
// in bf16 and cs / S_prev / y / S_c in f32.  A launch for S_c moves ~106 MB
// (0.032 ms at 3.35 TB/s), one for y ~232 MB (0.069 ms), against at most
// ~27 GFLOP (0.027 ms at 989 TFLOP/s bf16).  Bytes bound both.
//
// Three kernels; the launcher's plan picks one by dtype and shape:
//
// ssd_tc_kernel (bf16 operands, the prefill's): one block per program and
// role.  The block copies the program's C, B and xdt (and cs) into shared
// memory in one go (16-byte cp.async, rows XOR-swizzled so that ldmatrix is
// free of bank conflicts) and runs every product on the tensor cores
// (mma.sync m16n8k16, bf16 in, f32 accumulators):
//  - role y: each warp owns a pair of 16-row tiles, i and the mirrored
//    nrt-1-i, so all warps walk the same number of column tiles j <= i.
//    G = C B^T on a (16, 16) tile is exact (bf16 products, f32 sums).  L o G
//    is f32 in registers and enters the next product as hi = bf16(G) and
//    lo = bf16(G - hi), two products against xdt: one bf16 rounding of G
//    would cost ~5e-3 at the prefill's inputs, the split leaves ~2^-17 of G.
//    The G accumulator is, register for register, the A fragment of that
//    product (no shared-memory round trip).  The inter-chunk term comes
//    first, as C (S_hi + S_lo)^T from S_prev split the same way, scaled by
//    exp(cs_i) in registers.
//  - role S: warps split the (n, hp) output by 16-row and 16-column tiles and
//    walk all q rows; A = (w o B)^T is loaded transposed (ldmatrix.trans),
//    scaled by w in registers and split into hi / lo.
//  A y launch whose program does not fit in shared memory with S_prev's
//  hi / lo copy (q = 256 at hp = n = 128) goes to the SIMT kernel.
//
// ssd_tf32_kernel (f32 operands, the f32 consistency prefill's): the same
// roles and warp tiles as the first, on mma.sync m16n8k8 in 3xTF32: each f32
// operand split x = hi + lo (hi = tf32(x), lo = tf32(x - hi)) and a product
// taken as al bh + ah bl + ah bh with f32 accumulation, which keeps ~2^-21 of
// each term where one TF32 rounding would cost ~2^-11 (K6's f32 path does the
// same).  An f32 program is twice a bf16 one's bytes (C, B and xdt alone are
// 196 KB at q = 256, hp = n = 64), so only C (the y role's rows) and cs stay
// for the whole block; B and xdt stream through a two-slot ring of j tiles
// (64, 32 or 16 rows: the longest that leaves room for a second block on the
// SM, else the longest that fits) by 16-byte cp.async, the next tile in
// flight while the current one is used.  The y role takes G a strip of up to
// four (16, 8) tiles at a time, so that each k step's split A fragment of C
// feeds four independent accumulators.  Fragments are read as f32
// straight from shared memory with the k order of each product permuted
// (fragment slot c holds k = 2c, slot c + 4 holds k = 2c + 1): the G = C B^T
// accumulator is then, register for register, the A fragment of the next
// product (L o G) xdt, and the row strides (n + 8, hp + 4; n + 4 for the S
// role's transposed B) put each fragment load's 32 words in distinct banks.
// The y role runs a warp for each mirrored pair of 16-row tiles (twice as
// many, each with half of the columns, where hp > 64), up to 512 threads.
//
// ssd_simt_kernel (the last choice: shapes that neither tensor-core kernel
// fits): the port's first design.  Per program, one block for each 64-row
// tile of y walking the column tiles j <= i through shared memory, plus one
// block for S_c; every product in full f32 on the SIMT units.
//
// hp and n are multiples of 16 up to 128 in all three.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int MAXD = 128;           // largest hp and n
constexpr long long MAX_SMEM = 232448;
enum Roles { ROLE_Y = 1, ROLE_S = 2, ROLE_BOTH = 3 };

// ============================================================== SIMT kernel

constexpr int R = 64;       // rows of a y tile, and columns of a j tile
constexpr int THREADS = 256;
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

// blockIdx.y + role0 is the block's role: a y row tile below n_row_tiles,
// the S block at n_row_tiles.
template <typename T>
__global__ void __launch_bounds__(THREADS)
ssd_simt_kernel(const T* __restrict__ xdt, const float* __restrict__ cs,
                const T* __restrict__ B, const T* __restrict__ C,
                const float* __restrict__ S_prev, float* __restrict__ y,
                float* __restrict__ S_c, int q, int hp, int n, int role0) {
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
  const int role = static_cast<int>(blockIdx.y) + role0;

  for (int i = tid; i < q; i += THREADS) s_cs[i] = csp[i];
  __syncthreads();

  if (role == n_row_tiles) {
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
  const int i0 = role * R;
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

long long simt_smem_bytes(int q, int hp, int n) {
  const long long sg = static_cast<long long>(R) * (R + 1) > static_cast<long long>(hp) * (n + 1)
                           ? static_cast<long long>(R) * (R + 1)
                           : static_cast<long long>(hp) * (n + 1);
  return 4LL * (q + 2LL * R * (n + 1) + static_cast<long long>(R) * (hp + 1) + sg);
}

template <typename T>
int launch_simt(const void* xdt, const float* cs, const void* B, const void* C,
                const float* S_prev, float* y, float* S_c, int P, int q, int hp, int n,
                int roles, cudaStream_t stream) {
  const long long smem = simt_smem_bytes(q, hp, n);
  cudaError_t err = cudaFuncSetAttribute(ssd_simt_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_row_tiles = (q + R - 1) / R;
  const int blocks_y = (roles & ROLE_Y ? n_row_tiles : 0) + (roles & ROLE_S ? 1 : 0);
  const int role0 = roles & ROLE_Y ? 0 : n_row_tiles;
  dim3 grid(P, blocks_y);
  ssd_simt_kernel<T><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(xdt), cs, static_cast<const T*>(B), static_cast<const T*>(C),
      S_prev, y, S_c, q, hp, n, role0);
  return static_cast<int>(cudaGetLastError());
}

// ======================================================= tensor-core kernel

constexpr int TC_THREADS = 256;
constexpr int TC_WARPS = TC_THREADS / 32;
constexpr int MAX_NT = MAXD / 8;    // n8 tiles of a 128-wide output row

typedef __nv_bfloat16 bf16;

// Shared-memory layout of one block (byte offsets, 16-aligned).  qp is q
// rounded up to 16; rows q .. qp-1 are zero.
struct TcLayout {
  long long c, b, x, cs, s, total;   // total < 0: does not fit
};

__host__ __device__ inline TcLayout tc_layout(int q, int hp, int n, int roles) {
  const long long qp = (q + 15) / 16 * 16;
  TcLayout L;
  long long off = 0;
  const bool with_y = roles & ROLE_Y;
  L.c = off;
  off += with_y ? qp * n * 2 : 0;
  L.b = off;
  off += qp * n * 2;
  L.x = off;
  off += qp * hp * 2;
  L.cs = off;
  off += qp * 4;
  L.s = off;
  off += with_y ? 2LL * hp * n * 2 : 0;   // S_prev's hi / lo copies
  L.total = off > MAX_SMEM ? -1 : off;
  return L;
}

// XOR swizzle of the 16-byte chunks of a row of `cw` chunks: the 8 rows that
// one ldmatrix reads at one logical chunk land in 8 distinct bank groups
// (exactly so when cw is a power of two; a permutation within the row always).
struct Swizzle {
  int shift, mask;
};

__host__ __device__ inline Swizzle make_swizzle(int cw) {
  const int low = cw & -cw;
  const int p = low < 8 ? low : 8;
  int shift = 0;
  if (cw < 8 && (8 % cw) == 0)
    for (int r = 8 / cw; r > 1; r >>= 1) ++shift;
  return Swizzle{shift, p - 1};
}

// element offset of (r, c) in a swizzled (rows, w) bf16 matrix; c % 8 == 0
// or any c within a chunk
__device__ __forceinline__ int sw_off(int r, int c, int w, Swizzle s) {
  const int chunk = (c >> 3) ^ ((r >> s.shift) & s.mask);
  return r * w + (chunk << 3) + (c & 7);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// (x0, x1) -> bf16 pairs hi = bf16(x) and lo = bf16(x - hi), x0 in the low half
__device__ __forceinline__ void split_pair(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x0 - hf.x, x1 - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

__device__ __forceinline__ float2 bf16x2_to_float2(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
}

// A (rows, w) row-major bf16 slab of global memory (rows q, zero to qp) into
// a swizzled shared matrix, by 16-byte cp.async (not waited for here).
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src, int q, int qp, int w,
                                          Swizzle s) {
  const int cw = w >> 3;
  for (int e = threadIdx.x; e < qp * cw; e += TC_THREADS) {
    const int r = e / cw, c = (e - r * cw) << 3;
    bf16* d = dst + sw_off(r, c, w, s);
    if (r < q)
      cp_async16(d, src + static_cast<long long>(r) * w + c);
    else
      *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
  }
}

// y[i0 .. i0+15][:] as the mma accumulator layout: acc[t][0..1] row g,
// columns 8t + 2c .. +1; acc[t][2..3] row g + 8.
__device__ __forceinline__ void store_y(float* yp, const float (&acc)[MAX_NT][4], int i0, int q,
                                        int hp) {
  const int lane = threadIdx.x & 31, g = lane >> 2, c = lane & 3;
#pragma unroll
  for (int t = 0; t < MAX_NT; ++t) {
    if (8 * t >= hp) break;
    const int col = 8 * t + 2 * c;
    if (i0 + g < q)
      *reinterpret_cast<float2*>(yp + static_cast<long long>(i0 + g) * hp + col) =
          make_float2(acc[t][0], acc[t][1]);
    if (i0 + g + 8 < q)
      *reinterpret_cast<float2*>(yp + static_cast<long long>(i0 + g + 8) * hp + col) =
          make_float2(acc[t][2], acc[t][3]);
  }
}

struct YTiles {
  bf16 *C, *B, *X, *Shi, *Slo;
  float* cs;
  int q, hp, n;
  Swizzle swn, swh;
};

// acc = exp(cs_i) * (C (S_hi + S_lo)^T) on rows i0 .. i0+15
__device__ __forceinline__ void y_inter(const YTiles& T, float (&acc)[MAX_NT][4], int i0) {
  const int lane = threadIdx.x & 31, g = lane >> 2;
  for (int kk0 = 0; kk0 < T.n; kk0 += 16) {
    uint32_t a[4];
    ldsm_x4(a, T.C + sw_off(i0 + (lane & 15), kk0 + ((lane >> 4) << 3), T.n, T.swn));
#pragma unroll
    for (int p = 0; p < MAX_NT / 2; ++p) {
      if (16 * p >= T.hp) break;
      const int off = sw_off(16 * p + (lane & 7) + ((lane >> 4) << 3),
                             kk0 + (((lane >> 3) & 1) << 3), T.n, T.swn);
      uint32_t bh[4], bl[4];
      ldsm_x4(bh, T.Shi + off);
      ldsm_x4(bl, T.Slo + off);
      mma16816(acc[2 * p], a, bh[0], bh[1]);
      mma16816(acc[2 * p + 1], a, bh[2], bh[3]);
      mma16816(acc[2 * p], a, bl[0], bl[1]);
      mma16816(acc[2 * p + 1], a, bl[2], bl[3]);
    }
  }
  const float e0 = expf(T.cs[i0 + g]), e1 = expf(T.cs[i0 + g + 8]);
#pragma unroll
  for (int t = 0; t < MAX_NT; ++t) {
    acc[t][0] *= e0;
    acc[t][1] *= e0;
    acc[t][2] *= e1;
    acc[t][3] *= e1;
  }
}

// L o G on one (16, 8) accumulator tile: rows ia (elements 0, 1) and ib
// (2, 3), columns j, j + 1
__device__ __forceinline__ void mask_decay(const YTiles& T, float (&gt)[4], int ia, int ib,
                                           float ca, float cb, int j) {
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const bool jin = j + e < T.q;
    const float cj = T.cs[j + e];
    gt[e] = (jin && ia < T.q && ia >= j + e) ? gt[e] * expf(ca - cj) : 0.f;
    gt[2 + e] = (jin && ib < T.q && ib >= j + e) ? gt[2 + e] * expf(cb - cj) : 0.f;
  }
}

// acc += (L o C B^T) xdt on rows i0 .. i0+15, over the column tiles j <= i
__device__ __forceinline__ void y_intra(const YTiles& T, float (&acc)[MAX_NT][4], int i0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, c = lane & 3;
  const int ia = i0 + g, ib = ia + 8;
  const float ca = T.cs[ia], cb = T.cs[ib];
  for (int j0 = 0; j0 <= i0; j0 += 16) {
    float g0[4] = {0.f, 0.f, 0.f, 0.f}, g1[4] = {0.f, 0.f, 0.f, 0.f};
    for (int kk0 = 0; kk0 < T.n; kk0 += 16) {
      uint32_t a[4], b[4];
      ldsm_x4(a, T.C + sw_off(i0 + (lane & 15), kk0 + ((lane >> 4) << 3), T.n, T.swn));
      ldsm_x4(b, T.B + sw_off(j0 + (lane & 7) + ((lane >> 4) << 3),
                              kk0 + (((lane >> 3) & 1) << 3), T.n, T.swn));
      mma16816(g0, a, b[0], b[1]);
      mma16816(g1, a, b[2], b[3]);
    }
    mask_decay(T, g0, ia, ib, ca, cb, j0 + 2 * c);
    mask_decay(T, g1, ia, ib, ca, cb, j0 + 8 + 2 * c);
    uint32_t ahi[4], alo[4];
    split_pair(g0[0], g0[1], ahi[0], alo[0]);
    split_pair(g0[2], g0[3], ahi[1], alo[1]);
    split_pair(g1[0], g1[1], ahi[2], alo[2]);
    split_pair(g1[2], g1[3], ahi[3], alo[3]);
#pragma unroll
    for (int p = 0; p < MAX_NT / 2; ++p) {
      if (16 * p >= T.hp) break;
      uint32_t b[4];
      ldsm_x4_t(b, T.X + sw_off(j0 + (lane & 7) + (((lane >> 3) & 1) << 3),
                                16 * p + ((lane >> 4) << 3), T.hp, T.swh));
      mma16816(acc[2 * p], ahi, b[0], b[1]);
      mma16816(acc[2 * p + 1], ahi, b[2], b[3]);
      mma16816(acc[2 * p], alo, b[0], b[1]);
      mma16816(acc[2 * p + 1], alo, b[2], b[3]);
    }
  }
}

__device__ __forceinline__ void zero(float (&acc)[MAX_NT][4]) {
#pragma unroll
  for (int t = 0; t < MAX_NT; ++t) acc[t][0] = acc[t][1] = acc[t][2] = acc[t][3] = 0.f;
}

__device__ void tc_role_y(const TcLayout& L, unsigned char* sm, const bf16* X, const float* csp,
                          const bf16* Bp, const bf16* Cp, const float* Sp, float* yp, int q,
                          int hp, int n) {
  const int qp = (q + 15) & ~15;
  const int tid = threadIdx.x, warp = tid >> 5;
  YTiles T;
  T.C = reinterpret_cast<bf16*>(sm + L.c);
  T.B = reinterpret_cast<bf16*>(sm + L.b);
  T.X = reinterpret_cast<bf16*>(sm + L.x);
  T.Shi = reinterpret_cast<bf16*>(sm + L.s);
  T.Slo = T.Shi + hp * n;
  T.cs = reinterpret_cast<float*>(sm + L.cs);
  T.q = q;
  T.hp = hp;
  T.n = n;
  T.swn = make_swizzle(n >> 3);
  T.swh = make_swizzle(hp >> 3);

  load_rows(T.C, Cp, q, qp, n, T.swn);
  load_rows(T.B, Bp, q, qp, n, T.swn);
  load_rows(T.X, X, q, qp, hp, T.swh);
  for (int i = tid; i < qp; i += TC_THREADS) T.cs[i] = i < q ? csp[i] : 0.f;
  // S_prev (hp, n) f32 -> hi / lo bf16 copies, 4 values a step
  for (int e = tid; e < hp * n / 4; e += TC_THREADS) {
    const int h = (4 * e) / n, kk = (4 * e) % n;
    const float4 v = reinterpret_cast<const float4*>(Sp)[e];
    uint32_t h01, l01, h23, l23;
    split_pair(v.x, v.y, h01, l01);
    split_pair(v.z, v.w, h23, l23);
    const int off = sw_off(h, kk, n, T.swn);
    *reinterpret_cast<uint2*>(T.Shi + off) = make_uint2(h01, h23);
    *reinterpret_cast<uint2*>(T.Slo + off) = make_uint2(l01, l23);
  }
  cp_async_wait_all();
  __syncthreads();

  const int nrt = qp >> 4, npairs = (nrt + 1) >> 1;
  float acc[MAX_NT][4];
  for (int pi = warp; pi < npairs; pi += TC_WARPS)
    for (int u = 0; u < 2; ++u) {
      const int it = u == 0 ? pi : nrt - 1 - pi;
      if (u == 1 && it == pi) break;
      zero(acc);
      y_inter(T, acc, 16 * it);
      y_intra(T, acc, 16 * it);
      store_y(yp, acc, 16 * it, q, hp);
    }
}

__device__ void tc_role_s(const TcLayout& L, unsigned char* sm, const bf16* X, const float* csp,
                          const bf16* Bp, float* sp, int q, int hp, int n) {
  const int qp = (q + 15) & ~15;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, c = lane & 3;
  bf16* sB = reinterpret_cast<bf16*>(sm + L.b);
  bf16* sX = reinterpret_cast<bf16*>(sm + L.x);
  float* sW = reinterpret_cast<float*>(sm + L.cs);
  const Swizzle swn = make_swizzle(n >> 3), swh = make_swizzle(hp >> 3);
  load_rows(sB, Bp, q, qp, n, swn);
  load_rows(sX, X, q, qp, hp, swh);
  const float last = csp[q - 1];
  for (int i = tid; i < qp; i += TC_THREADS) sW[i] = i < q ? expf(last - csp[i]) : 0.f;
  cp_async_wait_all();
  __syncthreads();

  // warp -> (16-row tile m of S_c, column-tile pairs p = s, s + ns, ...)
  const int mt = n >> 4, ns = TC_WARPS / mt;
  const int m = warp % mt, s = warp / mt;
  if (s >= ns) return;
  float acc[MAX_NT][4];
  zero(acc);
  for (int j0 = 0; j0 < qp; j0 += 16) {
    uint32_t raw[4], ahi[4], alo[4];
    ldsm_x4_t(raw, sB + sw_off(j0 + (lane & 7) + ((lane >> 4) << 3),
                               16 * m + (((lane >> 3) & 1) << 3), n, swn));
    const float2 w01 = make_float2(sW[j0 + 2 * c], sW[j0 + 2 * c + 1]);
    const float2 w89 = make_float2(sW[j0 + 2 * c + 8], sW[j0 + 2 * c + 9]);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float2 v = bf16x2_to_float2(raw[r]);
      const float2 w = r < 2 ? w01 : w89;
      split_pair(v.x * w.x, v.y * w.y, ahi[r], alo[r]);
    }
#pragma unroll
    for (int p = 0; p < MAX_NT / 2; ++p) {
      if (16 * p >= hp) break;
      if (p % ns != s) continue;
      uint32_t b[4];
      ldsm_x4_t(b, sX + sw_off(j0 + (lane & 7) + (((lane >> 3) & 1) << 3),
                               16 * p + ((lane >> 4) << 3), hp, swh));
      mma16816(acc[2 * p], ahi, b[0], b[1]);
      mma16816(acc[2 * p + 1], ahi, b[2], b[3]);
      mma16816(acc[2 * p], alo, b[0], b[1]);
      mma16816(acc[2 * p + 1], alo, b[2], b[3]);
    }
  }
  const int r0 = 16 * m + g;
#pragma unroll
  for (int t = 0; t < MAX_NT; ++t) {
    if (8 * t >= hp) break;
    if ((t >> 1) % ns != s) continue;
    const int col = 8 * t + 2 * c;
    *reinterpret_cast<float2*>(sp + r0 * hp + col) = make_float2(acc[t][0], acc[t][1]);
    *reinterpret_cast<float2*>(sp + (r0 + 8) * hp + col) = make_float2(acc[t][2], acc[t][3]);
  }
}

// One block per (program, role): ROLES = ROLE_Y, ROLE_S, or ROLE_BOTH with
// the role from blockIdx.y (0: y, 1: S).
template <int ROLES>
__global__ void __launch_bounds__(TC_THREADS, 2)
ssd_tc_kernel(const bf16* __restrict__ xdt, const float* __restrict__ cs,
              const bf16* __restrict__ B, const bf16* __restrict__ C,
              const float* __restrict__ S_prev, float* __restrict__ y,
              float* __restrict__ S_c, int q, int hp, int n) {
  extern __shared__ __align__(128) unsigned char tc_smem[];
  const TcLayout L = tc_layout(q, hp, n, ROLES);
  const long long p = blockIdx.x;
  const int role = ROLES == ROLE_BOTH ? (blockIdx.y == 0 ? ROLE_Y : ROLE_S) : ROLES;
  if (role == ROLE_Y)
    tc_role_y(L, tc_smem, xdt + p * q * hp, cs + p * q, B + p * q * n, C + p * q * n,
              S_prev + p * hp * n, y + p * q * hp, q, hp, n);
  else
    tc_role_s(L, tc_smem, xdt + p * q * hp, cs + p * q, B + p * q * n, S_c + p * n * hp, q,
              hp, n);
}

template <int ROLES>
int launch_tc_roles(const void* xdt, const float* cs, const void* B, const void* C,
                    const float* S_prev, float* y, float* S_c, int P, int q, int hp, int n,
                    long long smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(ssd_tc_kernel<ROLES>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(ssd_tc_kernel<ROLES>,
                             cudaFuncAttributePreferredSharedMemoryCarveout, 100);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(P, ROLES == ROLE_BOTH ? 2 : 1);
  ssd_tc_kernel<ROLES><<<grid, TC_THREADS, smem, stream>>>(
      static_cast<const bf16*>(xdt), cs, static_cast<const bf16*>(B),
      static_cast<const bf16*>(C), S_prev, y, S_c, q, hp, n);
  return static_cast<int>(cudaGetLastError());
}

// ================================================ tensor-core f32 kernel (3xTF32)

constexpr int T32_MAX_THREADS = 512;
constexpr long long SM_SMEM = 233472;       // shared memory of one Hopper SM
constexpr long long BLOCK_RESERVED = 1024;  // what the runtime keeps of it for each block
constexpr int T32_S_WARPS = 8;      // warps of the S role

__device__ __forceinline__ void cp_async16z(void* dst, const void* src, int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait_group() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(x));
  const float rest = x - __uint_as_float(hi);
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(lo) : "f"(rest));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a b in 3xTF32 (a = ah + al, b = bh + bl; al bl dropped): the small
// cross terms first, then hi * hi
__device__ __forceinline__ void mma_3xtf32(float (&d)[4], const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4], const uint32_t (&bh)[2],
                                           const uint32_t (&bl)[2]) {
  mma_tf32(d, al, bh[0], bh[1]);
  mma_tf32(d, ah, bl[0], bl[1]);
  mma_tf32(d, ah, bh[0], bh[1]);
}

// A fragment (16 x 8) from four f32 values, split into hi / lo
__device__ __forceinline__ void split_a(float a0, float a1, float a2, float a3, uint32_t (&hi)[4],
                                        uint32_t (&lo)[4]) {
  split_tf32(a0, hi[0], lo[0]);
  split_tf32(a1, hi[1], lo[1]);
  split_tf32(a2, hi[2], lo[2]);
  split_tf32(a3, hi[3], lo[3]);
}

__device__ __forceinline__ void split_b(float b0, float b1, uint32_t (&hi)[2], uint32_t (&lo)[2]) {
  split_tf32(b0, hi[0], lo[0]);
  split_tf32(b1, hi[1], lo[1]);
}

// Warps of the y role: one for each mirrored pair of 16-row tiles (i, nrt-1-i),
// twice over where hp > 64 (each warp then takes half of the n8 column tiles).
__host__ __device__ inline int t32_y_warps(int q, int hp) {
  const int nrt = (q + 15) / 16;
  return (nrt + 1) / 2 * (hp > 64 ? 2 : 1);
}

__host__ __device__ inline int t32_threads(int q, int hp, int roles) {
  const int wy = roles & ROLE_Y ? t32_y_warps(q, hp) : 0;
  const int ws = roles & ROLE_S ? T32_S_WARPS : 0;
  return 32 * (wy > ws ? wy : ws);
}

// Shared memory (floats) of one block with j tiles of jt rows.  y: C (qp, n + 8),
// cs (qp), and two ring slots of B (jt, n + 8) and xdt (jt, hp + 4); S: w (qp)
// and two slots of B (jt, n + 4) and xdt (jt, hp + 4).  The strides put the
// rows that one fragment load reads in distinct banks.
__host__ __device__ inline long long t32_floats(int q, int hp, int n, int roles, int jt) {
  const long long qp = (q + 15) / 16 * 16;
  const long long fy = qp * (n + 8) + qp + 2LL * jt * ((n + 8) + (hp + 4));
  const long long fs = qp + 2LL * jt * ((n + 4) + (hp + 4));
  const long long a = roles & ROLE_Y ? fy : 0, b = roles & ROLE_S ? fs : 0;
  return a > b ? a : b;
}

// The j tile (64, 32 or 16 rows): the longest whose block leaves room for a
// second block on its SM (a y block at q = 256 is 8 warps, too few alone to
// keep the tensor cores fed), else the longest that fits; 0 where none fits
// or the y role would need more than T32_MAX_THREADS threads.
__host__ __device__ inline int t32_jt(int q, int hp, int n, int roles) {
  if (t32_threads(q, hp, roles) > T32_MAX_THREADS) return 0;
  for (int jt = 64; jt >= 16; jt >>= 1)
    if (4 * t32_floats(q, hp, n, roles, jt) <= SM_SMEM / 2 - BLOCK_RESERVED) return jt;
  for (int jt = 64; jt >= 16; jt >>= 1)
    if (4 * t32_floats(q, hp, n, roles, jt) <= MAX_SMEM) return jt;
  return 0;
}

// rows [r0, r0 + rows) of a (q, w) f32 matrix into shared memory with row stride
// S, zero past row q; 16-byte cp.async (not waited for here)
__device__ __forceinline__ void t32_load_rows(float* dst, int S, const float* src, int r0,
                                              int rows, int q, int w) {
  const int cw = w >> 2;
  for (int e = threadIdx.x; e < rows * cw; e += blockDim.x) {
    const int r = e / cw, c = (e - r * cw) << 2;
    const bool in = r0 + r < q;
    cp_async16z(dst + r * S + c, in ? src + static_cast<long long>(r0 + r) * w + c : src,
                in ? 16 : 0);
  }
}

__device__ void t32_role_y(float* sm, int jt, const float* X, const float* csp, const float* Bp,
                           const float* Cp, const float* Sp, float* yp, int q, int hp, int n) {
  const int qp = (q + 15) & ~15;
  const int SC = n + 8, SB = n + 8, SX = hp + 4;
  float* sC = sm;
  float* sCs = sC + qp * SC;
  float* ring = sCs + qp;
  const int slot_f = jt * (SB + SX);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, c = lane & 3;

  t32_load_rows(sC, SC, Cp, 0, qp, q, n);
  for (int i = tid; i < qp; i += blockDim.x) sCs[i] = i < q ? csp[i] : 0.f;
  const int nst = (qp + jt - 1) / jt;
  auto load_stage = [&](int st) {
    float* sB = ring + (st & 1) * slot_f;
    t32_load_rows(sB, SB, Bp, st * jt, jt, q, n);
    t32_load_rows(sB + jt * SB, SX, X, st * jt, jt, q, hp);
    cp_async_commit();
  };
  load_stage(0);                      // with C
  if (nst > 1) load_stage(1);

  // this warp: the mirrored pair (pi, nrt-1-pi) of 16-row tiles, n8 column
  // tiles nt0 .. nt0 + ntw - 1
  const int nrt = qp >> 4, npairs = (nrt + 1) >> 1;
  const int csplit = hp > 64 ? 2 : 1;
  const bool active = warp < npairs * csplit;
  const int pi = warp % npairs, half = warp / npairs;
  const int ntw = hp / 8 / csplit;
  const int nt0 = half * ntw;
  const int ntiles = nrt - 1 - pi == pi ? 1 : 2;
  const int it[2] = {pi, nrt - 1 - pi};

  float acc[2][MAX_NT / 2][4];
#pragma unroll
  for (int u = 0; u < 2; ++u)
#pragma unroll
    for (int t = 0; t < MAX_NT / 2; ++t) acc[u][t][0] = acc[u][t][1] = acc[u][t][2] = acc[u][t][3] = 0.f;

  for (int st = 0; st < nst; ++st) {
    if (st + 1 < nst)
      cp_async_wait_group<1>();
    else
      cp_async_wait_group<0>();
    __syncthreads();
    if (active && st == 0) {
      // inter-chunk term first: acc = exp(cs_i) * (C S_prev^T) on each tile
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        if (u >= ntiles) break;
        const int i0 = 16 * it[u];
        for (int k0 = 0; k0 < n; k0 += 8) {
          const float2 c0 = *reinterpret_cast<const float2*>(sC + (i0 + g) * SC + k0 + 2 * c);
          const float2 c1 = *reinterpret_cast<const float2*>(sC + (i0 + g + 8) * SC + k0 + 2 * c);
          uint32_t ah[4], al[4];
          split_a(c0.x, c1.x, c0.y, c1.y, ah, al);
#pragma unroll
          for (int t = 0; t < MAX_NT / 2; ++t) {
            if (t >= ntw) break;
            const int h = 8 * (nt0 + t) + g;
            const float2 s = __ldg(reinterpret_cast<const float2*>(Sp + h * n + k0 + 2 * c));
            uint32_t bh[2], bl[2];
            split_b(s.x, s.y, bh, bl);
            mma_3xtf32(acc[u][t], ah, al, bh, bl);
          }
        }
        const float e0 = expf(sCs[i0 + g]), e1 = expf(sCs[i0 + g + 8]);
#pragma unroll
        for (int t = 0; t < MAX_NT / 2; ++t) {
          acc[u][t][0] *= e0;
          acc[u][t][1] *= e0;
          acc[u][t][2] *= e1;
          acc[u][t][3] *= e1;
        }
      }
    }
    const float* sB = ring + (st & 1) * slot_f;
    const float* sX = sB + jt * SB;
    if (active) {
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        if (u >= ntiles) break;
        const int i0 = 16 * it[u];
        const int ia = i0 + g, ib = ia + 8;
        const float ca = sCs[ia], cb = sCs[ib];
        // the columns of this stage that rows i0 .. i0 + 15 need (j <= i0 + 15;
        // a multiple of 16), in strips of up to 32: G = C B^T on a strip's
        // (16, 8) tiles, each k step's A fragment split once for all of them
        const int jend = min(jt, i0 + 16 - st * jt);
        for (int jh = 0; jh < jend; jh += 32) {
          const int nj = min(4, (jend - jh) >> 3);
          float gs[4][4] = {};
#pragma unroll 2
          for (int k0 = 0; k0 < n; k0 += 8) {
            const float2 c0 = *reinterpret_cast<const float2*>(sC + ia * SC + k0 + 2 * c);
            const float2 c1 = *reinterpret_cast<const float2*>(sC + ib * SC + k0 + 2 * c);
            uint32_t ah[4], al[4];
            split_a(c0.x, c1.x, c0.y, c1.y, ah, al);
#pragma unroll
            for (int jj = 0; jj < 4; ++jj) {
              if (jj >= nj) break;
              const float2 bv =
                  *reinterpret_cast<const float2*>(sB + (jh + 8 * jj + g) * SB + k0 + 2 * c);
              uint32_t bh[2], bl[2];
              split_b(bv.x, bv.y, bh, bl);
              mma_3xtf32(gs[jj], ah, al, bh, bl);
            }
          }
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
            if (jj >= nj) break;
            // L o G: rows ia (elements 0, 1) and ib (2, 3), columns j0 + 2c, +1
            const int j0 = st * jt + jh + 8 * jj;
            float gv[4];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int j = j0 + 2 * c + e;
              const bool jin = j < q;
              const float cj = jin ? sCs[j] : 0.f;
              gv[e] = (jin && ia < q && ia >= j) ? gs[jj][e] * expf(ca - cj) : 0.f;
              gv[2 + e] = (jin && ib < q && ib >= j) ? gs[jj][2 + e] * expf(cb - cj) : 0.f;
            }
            // as the A fragment of (L o G) xdt, with the k (j) order
            // permuted: slot c is column 2c, slot c + 4 column 2c + 1
            uint32_t ah[4], al[4];
            split_a(gv[0], gv[2], gv[1], gv[3], ah, al);
            const float* x0 = sX + (jh + 8 * jj + 2 * c) * SX;
#pragma unroll
            for (int t = 0; t < MAX_NT / 2; ++t) {
              if (t >= ntw) break;
              const int col = 8 * (nt0 + t) + g;
              uint32_t bh[2], bl[2];
              split_b(x0[col], x0[SX + col], bh, bl);
              mma_3xtf32(acc[u][t], ah, al, bh, bl);
            }
          }
        }
      }
    }
    __syncthreads();
    if (st + 2 < nst) load_stage(st + 2);
  }

  if (!active) return;
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    if (u >= ntiles) break;
    const int ia = 16 * it[u] + g;
#pragma unroll
    for (int t = 0; t < MAX_NT / 2; ++t) {
      if (t >= ntw) break;
      const int col = 8 * (nt0 + t) + 2 * c;
      if (ia < q)
        *reinterpret_cast<float2*>(yp + static_cast<long long>(ia) * hp + col) =
            make_float2(acc[u][t][0], acc[u][t][1]);
      if (ia + 8 < q)
        *reinterpret_cast<float2*>(yp + static_cast<long long>(ia + 8) * hp + col) =
            make_float2(acc[u][t][2], acc[u][t][3]);
    }
  }
}

// NP: the most column-tile pairs (16 columns) one warp owns, so that only
// 2 NP accumulator tiles are held (the S launch sizes it: 2 at hp = n = 64)
template <int NP>
__device__ void t32_role_s(float* sm, int jt, const float* X, const float* csp, const float* Bp,
                           float* sp, int q, int hp, int n) {
  const int qp = (q + 15) & ~15;
  const int SB = n + 4, SX = hp + 4;
  float* sW = sm;
  float* ring = sW + qp;
  const int slot_f = jt * (SB + SX);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, c = lane & 3;
  const float last = csp[q - 1];
  for (int i = tid; i < qp; i += blockDim.x) sW[i] = i < q ? expf(last - csp[i]) : 0.f;
  const int nst = (qp + jt - 1) / jt;
  auto load_stage = [&](int st) {
    float* sB = ring + (st & 1) * slot_f;
    t32_load_rows(sB, SB, Bp, st * jt, jt, q, n);
    t32_load_rows(sB + jt * SB, SX, X, st * jt, jt, q, hp);
    cp_async_commit();
  };
  load_stage(0);
  if (nst > 1) load_stage(1);

  // warp -> (16-row tile m of S_c, column-tile pairs p = s, s + ns, ...:
  // its pair number u is p = s + u * ns, accumulators 2u, 2u + 1)
  const int nw = blockDim.x >> 5;
  const int mt = n >> 4, ns = nw / mt, pairs = hp >> 4;
  const int m = warp % mt, s = warp / mt;
  const bool active = s < ns;
  const int r0 = 16 * m + g;
  float acc[2 * NP][4];
#pragma unroll
  for (int t = 0; t < 2 * NP; ++t) acc[t][0] = acc[t][1] = acc[t][2] = acc[t][3] = 0.f;

  for (int st = 0; st < nst; ++st) {
    if (st + 1 < nst)
      cp_async_wait_group<1>();
    else
      cp_async_wait_group<0>();
    __syncthreads();
    const float* sB = ring + (st & 1) * slot_f;
    const float* sX = sB + jt * SB;
    if (active) {
      for (int jj = 0; jj < jt; jj += 8) {
        const int j0 = st * jt + jj;
        if (j0 >= qp) break;
        // A = (w o B)^T on (16, 8), the k (j) order permuted as in the y role
        const float w0 = sW[j0 + 2 * c], w1 = sW[j0 + 2 * c + 1];
        const float* b0 = sB + (jj + 2 * c) * SB + r0;
        const float* b1 = b0 + SB;
        uint32_t ah[4], al[4];
        split_a(w0 * b0[0], w0 * b0[8], w1 * b1[0], w1 * b1[8], ah, al);
        const float* x0 = sX + (jj + 2 * c) * SX;
#pragma unroll
        for (int u = 0; u < NP; ++u) {
          const int p = s + u * ns;
          if (p >= pairs) break;
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int h = 16 * p + 8 * e + g;
            uint32_t bh[2], bl[2];
            split_b(x0[h], x0[SX + h], bh, bl);
            mma_3xtf32(acc[2 * u + e], ah, al, bh, bl);
          }
        }
      }
    }
    __syncthreads();
    if (st + 2 < nst) load_stage(st + 2);
  }

  if (!active) return;
#pragma unroll
  for (int u = 0; u < NP; ++u) {
    const int p = s + u * ns;
    if (p >= pairs) break;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int col = 16 * p + 8 * e + 2 * c;
      const float(&a)[4] = acc[2 * u + e];
      *reinterpret_cast<float2*>(sp + r0 * hp + col) = make_float2(a[0], a[1]);
      *reinterpret_cast<float2*>(sp + (r0 + 8) * hp + col) = make_float2(a[2], a[3]);
    }
  }
}

// One block per (program, role): ROLES = ROLE_Y, ROLE_S, or ROLE_BOTH with
// the role from blockIdx.y (0: y, 1: S); NP as t32_role_s takes it.  An S
// launch of at most two pairs a warp asks for three blocks an SM.
template <int ROLES, int NP>
__global__ void __launch_bounds__(ROLES == ROLE_S ? 32 * T32_S_WARPS : T32_MAX_THREADS,
                                  ROLES == ROLE_S && NP <= 2 ? 3 : 1)
ssd_tf32_kernel(const float* __restrict__ xdt, const float* __restrict__ cs,
                const float* __restrict__ B, const float* __restrict__ C,
                const float* __restrict__ S_prev, float* __restrict__ y,
                float* __restrict__ S_c, int q, int hp, int n, int jt) {
  extern __shared__ __align__(16) float t32_smem[];
  const long long p = blockIdx.x;
  const int role = ROLES == ROLE_BOTH ? (blockIdx.y == 0 ? ROLE_Y : ROLE_S) : ROLES;
  if (role == ROLE_Y)
    t32_role_y(t32_smem, jt, xdt + p * q * hp, cs + p * q, B + p * q * n, C + p * q * n,
               S_prev + p * hp * n, y + p * q * hp, q, hp, n);
  else
    t32_role_s<NP>(t32_smem, jt, xdt + p * q * hp, cs + p * q, B + p * q * n,
                   S_c + p * n * hp, q, hp, n);
}

template <int ROLES, int NP>
int launch_tf32_roles(const void* xdt, const float* cs, const void* B, const void* C,
                      const float* S_prev, float* y, float* S_c, int P, int q, int hp, int n,
                      int jt, cudaStream_t stream) {
  const long long smem = 4 * t32_floats(q, hp, n, ROLES, jt);
  cudaError_t err = cudaFuncSetAttribute(ssd_tf32_kernel<ROLES, NP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(P, ROLES == ROLE_BOTH ? 2 : 1);
  ssd_tf32_kernel<ROLES, NP><<<grid, t32_threads(q, hp, ROLES), smem, stream>>>(
      static_cast<const float*>(xdt), cs, static_cast<const float*>(B),
      static_cast<const float*>(C), S_prev, y, S_c, q, hp, n, jt);
  return static_cast<int>(cudaGetLastError());
}

// The S launch at (hp, n): T32_S_WARPS warps over n/16 row tiles hold the
// hp/16 column-tile pairs, at most NP a warp (a power of two up to 8).
int launch_tf32_state(const void* xdt, const float* cs, const void* B, float* S_c, int P, int q,
                      int hp, int n, int jt, cudaStream_t stream) {
  const int ns = T32_S_WARPS / (n >> 4), pairs = hp >> 4;
  const int need = (pairs + ns - 1) / ns;
  if (need <= 1)
    return launch_tf32_roles<ROLE_S, 1>(xdt, cs, B, nullptr, nullptr, nullptr, S_c, P, q, hp, n,
                                        jt, stream);
  if (need <= 2)
    return launch_tf32_roles<ROLE_S, 2>(xdt, cs, B, nullptr, nullptr, nullptr, S_c, P, q, hp, n,
                                        jt, stream);
  if (need <= 4)
    return launch_tf32_roles<ROLE_S, 4>(xdt, cs, B, nullptr, nullptr, nullptr, S_c, P, q, hp, n,
                                        jt, stream);
  return launch_tf32_roles<ROLE_S, 8>(xdt, cs, B, nullptr, nullptr, nullptr, S_c, P, q, hp, n,
                                      jt, stream);
}

}  // namespace

// Dynamic shared memory of the SIMT kernel at (q, hp, n).
extern "C" long long repro_ssd_chunk_smem_bytes(int q, int hp, int n) {
  return simt_smem_bytes(q, hp, n);
}

// Dynamic shared memory of the tensor-core kernel at (q, hp, n) for the
// outputs `roles` (1: y, 2: S_c, 3: both); -1 where it does not fit.
extern "C" long long repro_ssd_chunk_tc_smem_bytes(int q, int hp, int n, int roles) {
  return tc_layout(q, hp, n, roles).total;
}

// Dynamic shared memory of the f32 tensor-core kernel at (q, hp, n) for the
// outputs `roles`; -1 where it does not fit (or would need more than 512
// threads).
extern "C" long long repro_ssd_chunk_tf32_smem_bytes(int q, int hp, int n, int roles) {
  const int jt = t32_jt(q, hp, n, roles);
  return jt > 0 ? 4 * t32_floats(q, hp, n, roles, jt) : -1;
}

// xdt (P, q, hp), B and C (P, q, n) all f32 (dtype 0) or all bf16 (dtype 1);
// cs (P, q) f32, S_prev (P, hp, n) f32; outputs y (P, q, hp) and S_c (P, n, hp)
// f32, written where `roles` asks (1: y, 2: S_c, 3: both; the other output
// may be null, and a launch for S_c alone reads neither C nor S_prev, which
// may then be null too).
// `kernel` 0 is the SIMT kernel, 1 the tensor-core kernel (bf16 only), 2
// the f32 tensor-core kernel (f32 only).  Contiguous on the device; hp and n
// multiples of 16 up to 128.  Returns the cudaError_t of the launch (0 on
// success).
extern "C" int repro_ssd_chunk(const void* xdt, const float* cs, const void* B, const void* C,
                               const float* S_prev, float* y, float* S_c, int dtype, int P,
                               int q, int hp, int n, int roles, int kernel, void* stream_ptr) {
  if (P <= 0 || q <= 0) return 0;
  if (hp % 16 || n % 16 || hp <= 0 || n <= 0 || hp > MAXD || n > MAXD || (q + R - 1) / R + 1 > 65535 ||
      roles < ROLE_Y || roles > ROLE_BOTH)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (kernel == 1) {
    const long long smem = tc_layout(q, hp, n, roles).total;
    if (dtype != 1 || smem < 0) return static_cast<int>(cudaErrorInvalidValue);
    if (roles == ROLE_Y)
      return launch_tc_roles<ROLE_Y>(xdt, cs, B, C, S_prev, y, S_c, P, q, hp, n, smem, stream);
    if (roles == ROLE_S)
      return launch_tc_roles<ROLE_S>(xdt, cs, B, C, S_prev, y, S_c, P, q, hp, n, smem, stream);
    return launch_tc_roles<ROLE_BOTH>(xdt, cs, B, C, S_prev, y, S_c, P, q, hp, n, smem, stream);
  }
  if (kernel == 2) {
    const int jt = t32_jt(q, hp, n, roles);
    if (dtype != 0 || jt == 0) return static_cast<int>(cudaErrorInvalidValue);
    if (roles == ROLE_Y)
      return launch_tf32_roles<ROLE_Y, MAX_NT / 2>(xdt, cs, B, C, S_prev, y, S_c, P, q, hp, n, jt,
                                                   stream);
    if (roles == ROLE_S)
      return launch_tf32_state(xdt, cs, B, S_c, P, q, hp, n, jt, stream);
    return launch_tf32_roles<ROLE_BOTH, MAX_NT / 2>(xdt, cs, B, C, S_prev, y, S_c, P, q, hp, n,
                                                    jt, stream);
  }
  if (dtype == 1)
    return launch_simt<__nv_bfloat16>(xdt, cs, B, C, S_prev, y, S_c, P, q, hp, n, roles, stream);
  return launch_simt<float>(xdt, cs, B, C, S_prev, y, S_c, P, q, hp, n, roles, stream);
}
