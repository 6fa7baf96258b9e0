// K3: batched Boolean (OR-AND) matrix product, out = min(A @ B, 1).
//
// Replaces: src/repro/kernels/semiring.py, semiring_matmul (_semiring_mm_kernel),
// a 128^3-tiled clamp(A @ B) with an fp32 accumulator.  In the port it is the
// `cuda` backend's compose and the combine and act of the join scan.
//
// Bound on this card: the join calls it on (b, lp, lp) x (b, lp, lp) stacks
// with b ~ 1023 and lp = 64 (TRAFFIC) or 288 (e125), and on mat-vecs
// (b, lp, lp) x (b, lp, 1) and (b, 1, lp) x (b, lp, lp).  The operands are f32
// holding 0 or 1, so a 64^3 product moves 48 KiB for 0.5 Mop (~11 op/B) and a
// 288^3 one 972 KiB for 48 Mop (~49 op/B): both sit far below the tensor
// cores' op-to-byte balance, so device-memory bytes bound every shape.
//
// Design, three kernels chosen by shape (kernels/semiring.py `plan`):
// - Tiled (m, n > 1): tensor cores.  A persistent block walks work items
//   (batch element, T x T output tile; T = 64 or 96, whichever pads least) and
//   their 32-wide k slices as one flat sequence, so a 4-stage cp.async ring
//   (16-byte copies, zero-filled at the ragged edges) keeps the next slices --
//   of this item or the next one -- in flight while the current one is
//   multiplied.  Four warps each own a (T/2 x T/2) quarter of the tile.  The
//   f32 {0,1} values are read from shared memory and packed to bf16 in
//   registers (exact on {0,1}), then multiplied with mma.sync m16n8k16 into f32
//   accumulators (exact below 2^24).  B is row-major (n contiguous), so each
//   thread's four k slots of a fragment are mapped to k = t, t+4, t+8, t+12:
//   the same permutation on both operands leaves the product unchanged, lets
//   A and B fragments come from 32-bit loads, and with row strides of
//   k-slice + 4 and T + 8 floats every such load is free of bank conflicts.
//   The epilogue clamps, pairs lanes with one shuffle and stores 16 bytes a
//   thread.  No separate bf16 copy of the tiles is made in shared memory:
//   converting in registers costs no extra pass or barrier.
// - Mat-vec (n == 1): half a warp per row, 16-byte loads along k.
// - Vec-mat (m == 1): a block per (batch element, 128 columns); each warp
//   sums every 8th row of B with 16-byte coalesced loads, then shared memory
//   adds the eight partial sums.
// Shapes whose rows are not 16-byte aligned (k or n not a multiple of 4) take
// the same kernels with 4-byte copies.  Any (b, m, k, n) is taken.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr int BK = 32;       // k slice of one ring stage
constexpr int STAGES = 4;

template <int T>
struct Tile {
  static constexpr int SA = BK + 4;           // A slice row stride (floats)
  static constexpr int SB = T + 8;            // B slice row stride (floats)
  static constexpr int WM = T / 2, WN = T / 2;
  static constexpr int MT = WM / 16, NT = WN / 8;
  static constexpr int A_FLOATS = T * SA;
  static constexpr int STAGE_FLOATS = A_FLOATS + BK * SB;
  static constexpr int SMEM = STAGES * STAGE_FLOATS * 4;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte async copy of `bytes` (0 or 16) bytes, the rest zero-filled
__device__ __forceinline__ void cp_async16(float* dst, const float* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(bytes) : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

struct Item {
  long long batch;
  int row0, col0;
};

__device__ __forceinline__ Item decode_item(long long item, int tiles_m, int tiles_n, int T) {
  Item it;
  it.col0 = static_cast<int>(item % tiles_n) * T;
  item /= tiles_n;
  it.row0 = static_cast<int>(item % tiles_m) * T;
  it.batch = item / tiles_m;
  return it;
}

// Issue the copies of one ring stage: A[row0:+T, k0:+BK] and B[k0:+BK, col0:+T].
template <int T>
__device__ __forceinline__ void load_stage(float* sA, float* sB, const float* A,
                                           const float* B, int m, int n, int k, int row0,
                                           int col0, int k0, bool vec, int tid) {
  using C = Tile<T>;
  if (vec) {
#pragma unroll
    for (int e = tid; e < T * BK / 4; e += THREADS) {
      const int r = e / (BK / 4), c = (e % (BK / 4)) * 4;
      const int gr = row0 + r, gc = k0 + c;
      const bool in = gr < m && gc < k;
      cp_async16(sA + r * C::SA + c, in ? A + static_cast<long long>(gr) * k + gc : A,
                 in ? 16 : 0);
    }
#pragma unroll
    for (int e = tid; e < BK * T / 4; e += THREADS) {
      const int r = e / (T / 4), c = (e % (T / 4)) * 4;
      const int gr = k0 + r, gc = col0 + c;
      const bool in = gr < k && gc < n;
      cp_async16(sB + r * C::SB + c, in ? B + static_cast<long long>(gr) * n + gc : B,
                 in ? 16 : 0);
    }
  } else {
    for (int e = tid; e < T * BK; e += THREADS) {
      const int r = e / BK, c = e % BK;
      const int gr = row0 + r, gc = k0 + c;
      const bool in = gr < m && gc < k;
      cp_async4(sA + r * C::SA + c, in ? A + static_cast<long long>(gr) * k + gc : A,
                in ? 4 : 0);
    }
    for (int e = tid; e < BK * T; e += THREADS) {
      const int r = e / T, c = e % T;
      const int gr = k0 + r, gc = col0 + c;
      const bool in = gr < k && gc < n;
      cp_async4(sB + r * C::SB + c, in ? B + static_cast<long long>(gr) * n + gc : B,
                in ? 4 : 0);
    }
  }
}

template <int T>
__global__ void __launch_bounds__(THREADS)
semiring_mm_tc_kernel(const float* __restrict__ a, const float* __restrict__ b,
                      float* __restrict__ out, int m, int n, int k, int tiles_m,
                      int tiles_n, long long items, int vec) {
  using C = Tile<T>;
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int wm = (warp / 2) * C::WM, wn = (warp % 2) * C::WN;
  const int ks = (k + BK - 1) / BK;

  const long long mine = (items - blockIdx.x + gridDim.x - 1) / gridDim.x;
  const long long total = mine * ks;

  auto load = [&](long long it) {
    const long long item = blockIdx.x + (it / ks) * gridDim.x;
    const int k0 = static_cast<int>(it % ks) * BK;
    const Item w = decode_item(item, tiles_m, tiles_n, T);
    float* st = smem + (it % STAGES) * C::STAGE_FLOATS;
    load_stage<T>(st, st + C::A_FLOATS, a + w.batch * m * static_cast<long long>(k),
                  b + w.batch * k * static_cast<long long>(n), m, n, k, w.row0, w.col0, k0,
                  vec != 0, tid);
  };

  float acc[C::MT][C::NT][4];
#pragma unroll
  for (int i = 0; i < C::MT; ++i)
#pragma unroll
    for (int j = 0; j < C::NT; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < total) load(s);
    cp_async_commit();
  }

  for (long long it = 0; it < total; ++it) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();                 // stage it landed; stage it-1 is free
    if (it + STAGES - 1 < total) load(it + STAGES - 1);
    cp_async_commit();

    const float* sA = smem + (it % STAGES) * C::STAGE_FLOATS;
    const float* sB = sA + C::A_FLOATS;
#pragma unroll
    for (int kb = 0; kb < BK; kb += 16) {
      uint32_t af[C::MT][4];
#pragma unroll
      for (int mt = 0; mt < C::MT; ++mt) {
        const float* p = sA + (wm + mt * 16 + g) * C::SA + kb + t;
        af[mt][0] = pack_bf16(p[0], p[4]);
        af[mt][1] = pack_bf16(p[8 * C::SA], p[8 * C::SA + 4]);
        af[mt][2] = pack_bf16(p[8], p[12]);
        af[mt][3] = pack_bf16(p[8 * C::SA + 8], p[8 * C::SA + 12]);
      }
#pragma unroll
      for (int nt = 0; nt < C::NT; ++nt) {
        const float* q = sB + (kb + t) * C::SB + wn + nt * 8 + g;
        const uint32_t b0 = pack_bf16(q[0], q[4 * C::SB]);
        const uint32_t b1 = pack_bf16(q[8 * C::SB], q[12 * C::SB]);
#pragma unroll
        for (int mt = 0; mt < C::MT; ++mt) mma_bf16(acc[mt][nt], af[mt], b0, b1);
      }
    }

    if (it % ks == ks - 1) {         // last k slice of this item: clamp and store
      const Item w = decode_item(blockIdx.x + (it / ks) * gridDim.x, tiles_m, tiles_n, T);
      float* O = out + w.batch * m * static_cast<long long>(n);
#pragma unroll
      for (int mt = 0; mt < C::MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < C::NT; ++nt) {
          float* c = acc[mt][nt];
          // lane pairs (t, t^1) swap halves: even t takes row g, odd t row g+8,
          // each then holds 4 consecutive columns
          const bool odd = t & 1;
          const float s0 = odd ? c[0] : c[2], s1 = odd ? c[1] : c[3];
          const float r0 = __shfl_xor_sync(0xffffffffu, s0, 1);
          const float r1 = __shfl_xor_sync(0xffffffffu, s1, 1);
          const float4 v = odd ? make_float4(r0, r1, c[2], c[3]) : make_float4(c[0], c[1], r0, r1);
          const int row = w.row0 + wm + mt * 16 + g + (odd ? 8 : 0);
          const int col = w.col0 + wn + nt * 8 + 2 * (t & ~1);
          c[0] = c[1] = c[2] = c[3] = 0.f;
          if (row >= m) continue;
          float* dst = O + static_cast<long long>(row) * n + col;
          const float4 cl = make_float4(fminf(v.x, 1.f), fminf(v.y, 1.f), fminf(v.z, 1.f),
                                        fminf(v.w, 1.f));
          if (vec && col + 3 < n) {
            *reinterpret_cast<float4*>(dst) = cl;
          } else {
            if (col < n) dst[0] = cl.x;
            if (col + 1 < n) dst[1] = cl.y;
            if (col + 2 < n) dst[2] = cl.z;
            if (col + 3 < n) dst[3] = cl.w;
          }
        }
    }
  }
  cp_async_wait<0>();
}

// n == 1: out[r] = min(A[r, :] . v[batch(r), :], 1); half a warp per row.
template <bool VEC>
__global__ void __launch_bounds__(256)
semiring_matvec_kernel(const float* __restrict__ a, const float* __restrict__ v,
                       float* __restrict__ out, long long rows, int m, int k) {
  const long long row = blockIdx.x * 16LL + threadIdx.x / 16;
  const int l = threadIdx.x % 16;
  float s = 0.f;
  if (row < rows) {
    const float* ar = a + row * k;
    const float* vb = v + (row / m) * k;
    if (VEC) {
      for (int c = l * 4; c < k; c += 64) {
        const float4 x = __ldg(reinterpret_cast<const float4*>(ar + c));
        const float4 y = __ldg(reinterpret_cast<const float4*>(vb + c));
        s += x.x * y.x + x.y * y.y + x.z * y.z + x.w * y.w;
      }
    } else {
      for (int c = l; c < k; c += 16) s += __ldg(ar + c) * __ldg(vb + c);
    }
  }
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  if (l == 0 && row < rows) out[row] = fminf(s, 1.f);
}

// m == 1: out[b, j] = min(v[b, :] . B[b, :, j], 1).  A block per (batch
// element, column group); warp w sums rows w, w+8, ...
template <bool VEC>
__global__ void __launch_bounds__(256)
semiring_vecmat_kernel(const float* __restrict__ v, const float* __restrict__ b,
                       float* __restrict__ out, int k, int n, int groups) {
  constexpr int COLS = VEC ? 128 : 32;
  __shared__ float4 part[8][32];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long bat = blockIdx.x / groups;
  const int col = (blockIdx.x % groups) * COLS + lane * (VEC ? 4 : 1);
  const float* vb = v + bat * k;
  const float* B = b + bat * k * static_cast<long long>(n);
  float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
  if (col < n) {
#pragma unroll 4
    for (int r = warp; r < k; r += 8) {
      const float w = __ldg(vb + r);
      if (VEC) {
        const float4 x = __ldg(reinterpret_cast<const float4*>(B + static_cast<long long>(r) * n + col));
        s.x += w * x.x; s.y += w * x.y; s.z += w * x.z; s.w += w * x.w;
      } else {
        s.x += w * __ldg(B + static_cast<long long>(r) * n + col);
      }
    }
  }
  part[warp][lane] = s;
  __syncthreads();
  if (warp != 0 || col >= n) return;
  for (int w = 1; w < 8; ++w) {
    const float4 p = part[w][lane];
    s.x += p.x; s.y += p.y; s.z += p.z; s.w += p.w;
  }
  float* dst = out + bat * n + col;
  if (VEC) {
    *reinterpret_cast<float4*>(dst) =
        make_float4(fminf(s.x, 1.f), fminf(s.y, 1.f), fminf(s.z, 1.f), fminf(s.w, 1.f));
  } else {
    dst[0] = fminf(s.x, 1.f);
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

template <int T>
int launch_tiled(const float* a, const float* b, float* out, int batch, int m, int n, int k,
                 cudaStream_t stream) {
  using C = Tile<T>;
  const int tiles_m = (m + T - 1) / T, tiles_n = (n + T - 1) / T;
  const long long items = static_cast<long long>(batch) * tiles_m * tiles_n;
  // per-device cache of the resident-block count (SMs x blocks per SM)
  static int resident[64] = {0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (resident[dev] == 0) {
    err = cudaFuncSetAttribute(semiring_mm_tc_kernel<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, semiring_mm_tc_kernel<T>,
                                                        THREADS, C::SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    resident[dev] = sms * (per_sm > 0 ? per_sm : 1);
  }
  const unsigned grid = static_cast<unsigned>(items < resident[dev] ? items : resident[dev]);
  const int vec = k % 4 == 0 && n % 4 == 0 && aligned16(a) && aligned16(b) && aligned16(out);
  semiring_mm_tc_kernel<T><<<grid, THREADS, C::SMEM, stream>>>(a, b, out, m, n, k, tiles_m,
                                                               tiles_n, items, vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// a (batch, m, k), b (batch, k, n), out (batch, m, n): contiguous f32 on the
// device.  tile 64 or 96 is the output tile of the tensor-core kernel; the
// launcher sends n == 1 and m == 1 to repro_semiring_matvec / _vecmat.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int repro_semiring_matmul(const float* a, const float* b, float* out, int batch,
                                     int m, int n, int k, int tile, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (batch <= 0 || m <= 0 || n <= 0) return 0;
  if (k <= 0)
    return static_cast<int>(cudaMemsetAsync(
        out, 0, static_cast<size_t>(batch) * m * n * sizeof(float), stream));
  if (tile == 64) return launch_tiled<64>(a, b, out, batch, m, n, k, stream);
  if (tile == 96) return launch_tiled<96>(a, b, out, batch, m, n, k, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

// a (batch, m, k), v (batch, k), out (batch, m): clamp(a v).
extern "C" int repro_semiring_matvec(const float* a, const float* v, float* out, int batch,
                                     int m, int k, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const long long rows = static_cast<long long>(batch) * m;
  if (rows <= 0) return 0;
  const long long blocks = (rows + 15) / 16;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  if (k % 4 == 0 && aligned16(a) && aligned16(v))
    semiring_matvec_kernel<true><<<static_cast<unsigned>(blocks), 256, 0, stream>>>(
        a, v, out, rows, m, k);
  else
    semiring_matvec_kernel<false><<<static_cast<unsigned>(blocks), 256, 0, stream>>>(
        a, v, out, rows, m, k);
  return static_cast<int>(cudaGetLastError());
}

// v (batch, k), b (batch, k, n), out (batch, n): clamp(v b).
extern "C" int repro_semiring_vecmat(const float* v, const float* b, float* out, int batch,
                                     int k, int n, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (batch <= 0 || n <= 0) return 0;
  const bool vec = n % 4 == 0 && aligned16(b) && aligned16(out);
  const int cols = vec ? 128 : 32;
  const int groups = (n + cols - 1) / cols;
  const long long blocks = static_cast<long long>(batch) * groups;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  if (vec)
    semiring_vecmat_kernel<true><<<static_cast<unsigned>(blocks), 256, 0, stream>>>(
        v, b, out, k, n, groups);
  else
    semiring_vecmat_kernel<false><<<static_cast<unsigned>(blocks), 256, 0, stream>>>(
        v, b, out, k, n, groups);
  return static_cast<int>(cudaGetLastError());
}
