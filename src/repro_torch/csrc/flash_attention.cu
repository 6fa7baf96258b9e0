// K6: causal / sliding-window attention forward with an online softmax.
//
// Replaces: src/repro/kernels/flash_attention.py, flash_attention_fwd
// (_flash_fwd_kernel): grid (b*h, nq, nk) with the nk axis sequential, the
// (m, l, acc) state in VMEM scratch across it, fully masked blocks skipped
// with pl.when, the normalised output written on the last nk step.
//
// Bound on this card: zamba2-2.7b's prefill calls it on q, k, v of
// (2, 2048, 32, 80) bf16.  Causal, that is 2 * L^2 * hd operations per
// (batch, head) pair (QK^T and PV over the lower triangle): 43 GFLOP, about
// 0.043 ms at 989 TFLOP/s, against 63 MB of operands (0.019 ms at 3.35 TB/s).
// Operations bound it, so bf16 runs on the tensor cores.
//
// Design: the public layout (b, L, h, hd) is read in place (row stride h*hd),
// so no transpose copies exist.  One block per (q tile of 64 rows, b*h); a
// loop over k tiles inside the block takes the place of the TPU's sequential
// nk axis, and its range skips the tiles that the causal and window masks
// empty.  bf16: 4 warps, each owning 16 query rows; S = Q K^T and O += P V
// are mma.sync m16n8k16 (bf16 in, f32 accumulate).  The accumulator layout of
// S is the A-operand layout of the next product, so P (cast to bf16, as the
// plain version casts p to v's dtype) never leaves registers, and (m, l, O)
// stay in registers across the k loop.  The padded head_dim is a template
// parameter, a multiple of 16 (zamba2's 80 is 5 * 16); a head_dim that is a
// multiple of 8 (h2o-danube's 120) is zero-padded to it in shared memory.
// f32: a SIMT kernel in full f32 (the tensor cores would round to TF32), 4
// threads per query row, each holding a quarter of the row's q and O.  Masked scores are -inf and a row
// whose running max is still -inf uses 0 in its place, so no NaN arises.
// wgmma and TMA are the next steps.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;          // query rows per block
constexpr int BK = 64;          // keys per k tile (bf16 kernel)
constexpr int BK32 = 32;        // keys per k tile (f32 kernel)
constexpr int F32_MAX_HD = 128;
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_raw(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Range of k tiles [lo, hi) that hold a key visible to some query row of
// [q_first, q_last].
__device__ __forceinline__ void k_tile_range(int q_first, int q_last, int Lk, int bk,
                                             int causal, int window, int* lo, int* hi) {
  int key_hi = Lk - 1;
  if (causal) key_hi = min(key_hi, q_last);
  int key_lo = 0;
  if (window > 0) key_lo = max(0, q_first - window + 1);
  *lo = key_lo / bk;
  *hi = key_hi < key_lo ? *lo : key_hi / bk + 1;
}

__device__ __forceinline__ bool visible(int row, int col, int Lk, int causal, int window) {
  return col < Lk && (!causal || col <= row) && (window <= 0 || col > row - window);
}

// ----------------------------------------------------------------- bf16
template <int HD>   // head_dim padded to a multiple of 16; hd <= HD is the real one
__global__ void __launch_bounds__(128)
flash_bf16_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                  const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out,
                  int Lq, int Lk, int H, int hd, int causal, int window, float scale_log2) {
  constexpr int STR = HD + 8;   // padded smem row (bf16 elements): 16-byte aligned rows
  constexpr int KS = HD / 16;   // k-slices of the QK^T product
  constexpr int NT = BK / 8;    // n-tiles of S
  constexpr int OT = HD / 8;    // n-tiles of O
  constexpr int VEC = HD / 8;   // 16-byte vectors per padded row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sq = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sk = sq + BQ * STR;
  __nv_bfloat16* sv = sk + BK * STR;

  const int bh = blockIdx.y;
  const int bi = bh / H, hi = bh % H;
  const long long rs = static_cast<long long>(H) * hd;   // row stride
  const __nv_bfloat16* Q = q + (static_cast<long long>(bi) * Lq * H + hi) * hd;
  const __nv_bfloat16* K = k + (static_cast<long long>(bi) * Lk * H + hi) * hd;
  const __nv_bfloat16* V = v + (static_cast<long long>(bi) * Lk * H + hi) * hd;
  __nv_bfloat16* O = out + (static_cast<long long>(bi) * Lq * H + hi) * hd;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, tig = lane % 4;
  const int q0 = blockIdx.x * BQ;

  for (int e = tid; e < BQ * VEC; e += 128) {
    const int r = e / VEC, c = (e % VEC) * 8;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (q0 + r < Lq && c < hd) val = *reinterpret_cast<const uint4*>(Q + (q0 + r) * rs + c);
    *reinterpret_cast<uint4*>(sq + r * STR + c) = val;
  }
  __syncthreads();
  uint32_t qa[KS][4];
  {
    const __nv_bfloat16* base = sq + (warp * 16) * STR;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      const int c = kk * 16 + tig * 2;
      qa[kk][0] = *reinterpret_cast<const uint32_t*>(base + g * STR + c);
      qa[kk][1] = *reinterpret_cast<const uint32_t*>(base + (g + 8) * STR + c);
      qa[kk][2] = *reinterpret_cast<const uint32_t*>(base + g * STR + c + 8);
      qa[kk][3] = *reinterpret_cast<const uint32_t*>(base + (g + 8) * STR + c + 8);
    }
  }

  const int row0 = q0 + warp * 16 + g;   // this thread's rows: row0, row0 + 8
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};
  float o[OT][4];
#pragma unroll
  for (int t = 0; t < OT; ++t) o[t][0] = o[t][1] = o[t][2] = o[t][3] = 0.f;

  int kt_lo, kt_hi;
  k_tile_range(q0, min(q0 + BQ, Lq) - 1, Lk, BK, causal, window, &kt_lo, &kt_hi);
  for (int kt = kt_lo; kt < kt_hi; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();
    for (int e = tid; e < BK * VEC; e += 128) {
      const int r = e / VEC, c = (e % VEC) * 8;
      uint4 kv = make_uint4(0, 0, 0, 0), vv = make_uint4(0, 0, 0, 0);
      if (k0 + r < Lk && c < hd) {
        kv = *reinterpret_cast<const uint4*>(K + (k0 + r) * rs + c);
        vv = *reinterpret_cast<const uint4*>(V + (k0 + r) * rs + c);
      }
      *reinterpret_cast<uint4*>(sk + r * STR + c) = kv;
      *reinterpret_cast<uint4*>(sv + r * STR + c) = vv;
    }
    __syncthreads();

    float s[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
      const __nv_bfloat16* kr = sk + (nt * 8 + g) * STR;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(kr + kk * 16 + tig * 2);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(kr + kk * 16 + 8 + tig * 2);
        mma_bf16(s[nt], qa[kk], b0, b1);
      }
    }
    // scale into the log2 domain, mask, and take each row's max
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = row0 + (e >= 2 ? 8 : 0);
        const int col = k0 + nt * 8 + tig * 2 + (e & 1);
        const float val = visible(row, col, Lk, causal, window) ? s[nt][e] * scale_log2
                                                                : -INFINITY;
        s[nt][e] = val;
        mx[e >> 1] = fmaxf(mx[e >> 1], val);
      }
    float alpha[2], mu[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      mu[r] = m_new == -INFINITY ? 0.f : m_new;
      alpha[r] = exp2f(m[r] - mu[r]);
      m[r] = m_new;
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int t = 0; t < OT; ++t) {
      o[t][0] *= alpha[0]; o[t][1] *= alpha[0];
      o[t][2] *= alpha[1]; o[t][3] *= alpha[1];
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(s[nt][e] - mu[e >> 1]);
        s[nt][e] = p;
        l[e >> 1] += p;
      }
    // O += P V: the S accumulators of n-tiles 2j, 2j+1 are the A operand of k-slice j
#pragma unroll
    for (int j = 0; j < BK / 16; ++j) {
      uint32_t pa[4];
      pa[0] = pack_bf16(s[2 * j][0], s[2 * j][1]);
      pa[1] = pack_bf16(s[2 * j][2], s[2 * j][3]);
      pa[2] = pack_bf16(s[2 * j + 1][0], s[2 * j + 1][1]);
      pa[3] = pack_bf16(s[2 * j + 1][2], s[2 * j + 1][3]);
      const __nv_bfloat16* v0 = sv + (j * 16 + tig * 2) * STR;
#pragma unroll
      for (int t = 0; t < OT; ++t) {
        const int c = t * 8 + g;
        const uint32_t b0 = pack_raw(v0[c], v0[STR + c]);
        const uint32_t b1 = pack_raw(v0[8 * STR + c], v0[9 * STR + c]);
        mma_bf16(o[t], pa, b0, b1);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    l[r] = 1.f / fmaxf(l[r], 1e-30f);
  }
#pragma unroll
  for (int t = 0; t < OT; ++t) {
    const int c = t * 8 + tig * 2;
    if (c >= hd) continue;
    if (row0 < Lq)
      *reinterpret_cast<uint32_t*>(O + row0 * rs + c) = pack_bf16(o[t][0] * l[0], o[t][1] * l[0]);
    if (row0 + 8 < Lq)
      *reinterpret_cast<uint32_t*>(O + (row0 + 8) * rs + c) =
          pack_bf16(o[t][2] * l[1], o[t][3] * l[1]);
  }
}

// ------------------------------------------------------------------ f32
// 256 threads: 4 per query row.  Thread t4 of a row holds columns t4 + 4i.
__global__ void __launch_bounds__(256)
flash_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ out, int Lq, int Lk,
                 int H, int hd, int causal, int window, float scale_log2) {
  constexpr int CI = F32_MAX_HD / 4;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sk = reinterpret_cast<float*>(smem_raw);   // (BK32, hd)
  float* sv = sk + BK32 * hd;

  const int bh = blockIdx.y;
  const int bi = bh / H, hi = bh % H;
  const long long rs = static_cast<long long>(H) * hd;
  const float* Q = q + (static_cast<long long>(bi) * Lq * H + hi) * hd;
  const float* K = k + (static_cast<long long>(bi) * Lk * H + hi) * hd;
  const float* V = v + (static_cast<long long>(bi) * Lk * H + hi) * hd;
  float* O = out + (static_cast<long long>(bi) * Lq * H + hi) * hd;

  const int tid = threadIdx.x, t4 = tid % 4;
  const int q0 = blockIdx.x * BQ;
  const int row = q0 + tid / 4;
  const bool live_row = row < Lq;

  float qr[CI], acc[CI];
#pragma unroll
  for (int i = 0; i < CI; ++i) {
    const int c = t4 + 4 * i;
    qr[i] = (live_row && c < hd) ? Q[row * rs + c] * scale_log2 : 0.f;
    acc[i] = 0.f;
  }
  float m = -INFINITY, l = 0.f;

  int kt_lo, kt_hi;
  k_tile_range(q0, min(q0 + BQ, Lq) - 1, Lk, BK32, causal, window, &kt_lo, &kt_hi);
  for (int kt = kt_lo; kt < kt_hi; ++kt) {
    const int k0 = kt * BK32;
    __syncthreads();
    for (int e = tid; e < BK32 * hd; e += 256) {
      const int r = e / hd, c = e % hd;
      const bool in = k0 + r < Lk;
      sk[e] = in ? K[(k0 + r) * rs + c] : 0.f;
      sv[e] = in ? V[(k0 + r) * rs + c] : 0.f;
    }
    __syncthreads();
    float s[BK32];
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < BK32; ++j) {
      float part = 0.f;
#pragma unroll
      for (int i = 0; i < CI; ++i) {
        const int c = t4 + 4 * i;
        if (c < hd) part = fmaf(qr[i], sk[j * hd + c], part);
      }
      part += __shfl_xor_sync(0xffffffffu, part, 1);
      part += __shfl_xor_sync(0xffffffffu, part, 2);
      s[j] = visible(row, k0 + j, Lk, causal, window) ? part : -INFINITY;
      mx = fmaxf(mx, s[j]);
    }
    const float m_new = fmaxf(m, mx);
    const float mu = m_new == -INFINITY ? 0.f : m_new;
    const float alpha = exp2f(m - mu);
    m = m_new;
    l *= alpha;
#pragma unroll
    for (int i = 0; i < CI; ++i) acc[i] *= alpha;
#pragma unroll
    for (int j = 0; j < BK32; ++j) {
      const float p = exp2f(s[j] - mu);
      l += p;
#pragma unroll
      for (int i = 0; i < CI; ++i) {
        const int c = t4 + 4 * i;
        if (c < hd) acc[i] = fmaf(p, sv[j * hd + c], acc[i]);
      }
    }
  }
  if (!live_row) return;
  const float inv = 1.f / fmaxf(l, 1e-30f);
#pragma unroll
  for (int i = 0; i < CI; ++i) {
    const int c = t4 + 4 * i;
    if (c < hd) O[row * rs + c] = acc[i] * inv;
  }
}

template <int HD>
int launch_bf16(const void* q, const void* k, const void* v, void* out, int b, int Lq, int Lk,
                int H, int hd, int causal, int window, float scale_log2, cudaStream_t stream) {
  const int smem = (BQ + 2 * BK) * (HD + 8) * 2;
  cudaError_t err = cudaFuncSetAttribute(flash_bf16_kernel<HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((Lq + BQ - 1) / BQ, b * H);
  flash_bf16_kernel<HD><<<grid, 128, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out), Lq, Lk, H, hd,
      causal, window, scale_log2);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// 1 when the kernel takes this (dtype, head_dim): dtype 0 = f32 (head_dim up
// to 128), 1 = bf16 (head_dim a multiple of 8 up to 128).
extern "C" int repro_flash_supports(int dtype, int hd) {
  if (dtype == 1) return hd > 0 && hd % 8 == 0 && hd <= 128;
  return dtype == 0 && hd > 0 && hd <= F32_MAX_HD;
}

// q (b, Lq, h, hd), k and v (b, Lk, h, hd), out (b, Lq, h, hd): contiguous on
// the device, all f32 (dtype 0) or all bf16 (dtype 1).  Query i sees key j
// when (!causal || j <= i) and (window <= 0 || j > i - window).  Returns the
// cudaError_t of the launch (0 on success).
extern "C" int repro_flash_attention(const void* q, const void* k, const void* v, void* out,
                                     int dtype, int b, int Lq, int Lk, int h, int hd,
                                     int causal, int window, void* stream_ptr) {
  if (b <= 0 || Lq <= 0 || h <= 0) return 0;
  if (!repro_flash_supports(dtype, hd) || Lk <= 0 ||
      static_cast<long long>(b) * h > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const float scale_log2 = LOG2E / sqrtf(static_cast<float>(hd));
  if (dtype == 0) {
    const int smem = 2 * BK32 * hd * 4;
    dim3 grid((Lq + BQ - 1) / BQ, b * h);
    flash_f32_kernel<<<grid, 256, smem, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(out), Lq, Lk, h, hd, causal,
        window, scale_log2);
    return static_cast<int>(cudaGetLastError());
  }
  switch ((hd + 15) / 16) {
#define REPRO_FLASH_CASE(n) \
    case n: return launch_bf16<16 * n>(q, k, v, out, b, Lq, Lk, h, hd, causal, window, scale_log2, stream);
    REPRO_FLASH_CASE(1) REPRO_FLASH_CASE(2) REPRO_FLASH_CASE(3) REPRO_FLASH_CASE(4)
    REPRO_FLASH_CASE(5) REPRO_FLASH_CASE(6) REPRO_FLASH_CASE(7)
    default: return launch_bf16<128>(q, k, v, out, b, Lq, Lk, h, hd, causal, window, scale_log2, stream);
#undef REPRO_FLASH_CASE
  }
}
