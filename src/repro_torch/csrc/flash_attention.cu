// K6: causal / sliding-window attention forward with an online softmax.
//
// Replaces: src/repro/kernels/flash_attention.py, flash_attention_fwd
// (_flash_fwd_kernel): grid (b*h, nq, nk) with the nk axis sequential, the
// (m, l, acc) state in VMEM scratch across it, fully masked blocks skipped
// with pl.when, the normalised output written on the last nk step.
//
// Bound on this card: zamba2-2.7b's prefill calls it on q, k, v of
// (2, 2048, 32, 80) bf16.  Causal, that is 2 * L(L+1) * hd operations per
// (batch, head) pair (QK^T and PV over the lower triangle): 43 GFLOP, about
// 0.043 ms at 989 TFLOP/s, against 84 MB of q, k, v and output (0.025 ms at
// 3.35 TB/s).  Operations bound it, so both dtypes run on the tensor cores.
//
// Common to both kernels: the public layout (b, L, h, hd) is read in place
// (row stride h*hd), so no transpose is copied.  A block takes one query tile
// of one (batch, head) pair; a loop over 64-key tiles inside the block takes
// the place of the TPU's sequential nk axis, its range skipping the tiles
// that the causal and window masks empty, and only tiles that cross the
// diagonal, the window's edge or the end of the keys evaluate the mask.  K and
// V tiles stream through a ring of shared-memory stages, each stage's copies
// in flight while earlier stages are multiplied.  The grid's slow axis walks
// query tiles from the last (longest causal row range) to the first, so the
// longest blocks start first and the short ones fill the tail.  Masked scores
// are -inf and a row whose running max is still -inf uses 0 in its place, so
// no NaN arises.  A logit softcap c > 0 (the attention of configs with
// attn_logit_softcap) maps each scaled score s to c * tanh(s / c) before the
// mask, in f32 (tanhf), and the exponentials then take the capped score times
// log2(e); c = 0 leaves the path as it was, one uniform branch a score.
//
// bf16 (head_dim a multiple of 8 up to 128): a block of 128 query rows, two
// warpgroups of 64 rows each, a 4-stage K/V ring filled by TMA.  S = Q K^T is
// wgmma m64n64k16 with Q and K in shared memory; the online softmax runs on
// the accumulators in registers, its exponentials on the special-function
// unit alone (ex2.approx: p is rounded to bf16 next); O += P V is wgmma m64n{HD}k16 with P (cast to
// bf16, as the plain version casts p to v's dtype) as the register A operand
// and V as the transposed (MN-major) B operand in shared memory.  The two
// warpgroups of a block (and the two blocks an SM holds at head_dim <= 80)
// interleave, so one's softmax overlaps another's products.  Each warpgroup
// walks only its own run of visible tiles, and its index is broadcast from
// lane 0 so that ptxas treats the branches around each wgmma as uniform: a
// branch it must assume divergent makes it serialize every wgmma.  (Issuing
// S of tile i+1 beside P V of tile i, to overlap a warpgroup's own softmax,
// ran slower: ptxas serializes wgmmas whose accumulators are read before the
// last wait of the group.)  Every tile is stored in wgmma's
// no-swizzle core-matrix layout (8 rows x 16 bytes per 128-byte core matrix,
// the core matrices of one 8-column block stacked down the rows).  That is
// exactly what a TMA box of 8 columns x the tile's rows writes, so one thread
// copies a tile with head_dim/8 boxes through 4-D tensor maps over
// (b, L, h, hd) (rows past L and columns past hd arrive as zeros), and every
// other thread spends no instruction on loads; the tensor maps are made with
// cuTensorMapEncodeTiled, looked up at run time through the CUDA runtime's
// entry-point query, so nothing links against libcuda.  head_dim 80's
// 160-byte rows fit no 32/64/128-byte swizzle atom without padding to 96 or
// splitting rows; the no-swizzle layout needs neither, and its 128-byte core
// matrices are read without bank conflicts.  The padded head_dim HD (a multiple of 16, for the k16 steps of
// Q K^T) is a template parameter; a head_dim that is a multiple of 8 only is
// zero-padded to it by the boxes past hd.  Thread 0 issues the copies after a
// block-wide barrier that frees the oldest stage; there is no separate
// producer warp, since a stage costs it 2 * HD/8 TMA instructions.
//
// f32 (head_dim up to 128): a block of 64 query rows, 4 warps of 16 rows, a
// 2-stage K/V ring filled by 16-byte cp.async copies (4-byte ones where hd is
// not a multiple of 4).  Both products run on mma.sync m16n8k8 in TF32 with
// the 3xTF32 split (x = hi + lo, hi * hi + hi * lo + lo * hi with f32
// accumulation): each product keeps ~f32 accuracy, inside the plain version's
// 3e-5.  wgmma's TF32 form needs both operands K-major and V in P V is not, so
// the f32 path stays on mma.sync.  The S accumulator's column pair (2t, 2t+1)
// becomes the A operand's k slots (t, t+4) of the P V product, and V's rows
// are read in the same order, so P never leaves registers.  Row strides of
// HD + 4 floats keep every fragment load free of bank conflicts.
//
// Limits: bf16 head_dim a multiple of 8 up to 128, f32 head_dim up to 128;
// q, k and v 16-byte aligned; ceil(Lq / tile) <= 65535 (128 rows bf16, 64
// f32).  Shared memory a block: bf16 (128 + 4 * 128) * HD * 2 bytes (100 KB at
// head_dim 80, 160 KB at 128), f32 320 * (HD + 4) * 4 bytes (105 KB at 80,
// 165 KB at 128).

#include <cuda.h>   // CUtensorMap and its enums; the encoder is fetched at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BKV = 64;          // keys per K/V tile
constexpr int BQ16 = 128;        // query rows per block (bf16 kernel)
constexpr int BQ32 = 64;         // query rows per block (f32 kernel)
constexpr int STAGES16 = 4;
constexpr int STAGES32 = 2;
constexpr int MAX_HD = 128;
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(bytes) : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, int bytes) {
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

// Range of k tiles [lo, hi) that hold a key visible to some query row of
// [q_first, q_last].
__device__ __forceinline__ void k_tile_range(int q_first, int q_last, int Lk, int causal,
                                             int window, int* lo, int* hi) {
  int key_hi = Lk - 1;
  if (causal) key_hi = min(key_hi, q_last);
  int key_lo = 0;
  if (window > 0) key_lo = max(0, q_first - window + 1);
  *lo = key_lo / BKV;
  *hi = key_hi < key_lo ? *lo : key_hi / BKV + 1;
}

// Whether every key of [k0, k0 + BKV) is visible to every row of
// [r0, r0 + rows), and whether none is.
struct TileMask {
  bool full, empty;
};

__device__ __forceinline__ TileMask tile_mask(int r0, int rows, int k0, int Lk, int causal,
                                              int window) {
  const int r1 = r0 + rows - 1, k1 = k0 + BKV - 1;
  TileMask t;
  t.full = k1 < Lk && (!causal || k1 <= r0) && (window <= 0 || k0 > r1 - window);
  t.empty = k0 >= Lk || (causal && k0 > r1) || (window > 0 && k1 <= r0 - window);
  return t;
}

__device__ __forceinline__ bool visible(int row, int col, int Lk, int causal, int window) {
  return col < Lk && (!causal || col <= row) && (window <= 0 || col > row - window);
}

// 2^x on the special-function unit (relative error ~2^-22, denormals
// flushed); 2^-inf = 0.
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Online-softmax step for one thread's two rows (r = 0: row g, r = 1: row
// g + 8) over NT accumulator n-tiles s[nt*4 + e] (e >> 1 is the row) of raw
// scores: cap them when cap > 0 (s = cap * tanh(s * cap_in), cap_in = scale /
// cap; scale_log2 is then log2(e)), mask when the tile is not fully visible,
// take the row max, update (m, l) in the log2 domain, leave
// p = 2^(s * scale_log2 - m) in s (one FMA and one exponential a score), and
// return in alpha the factor by which the output accumulators must be
// rescaled (rescale_rows).  FAST_EXP takes the
// exponential on the special-function unit alone (the bf16 kernel, whose p is
// rounded to bf16); otherwise exp2f.
template <int NT, bool FAST_EXP>
__device__ __forceinline__ void online_softmax(float* s, float* m, float* l, float* alpha,
                                               bool full, int row0, int k0, int t, int Lk,
                                               int causal, int window, float scale_log2,
                                               float cap, float cap_in) {
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (cap > 0.f) s[nt * 4 + e] = cap * tanhf(s[nt * 4 + e] * cap_in);
      if (!full) {
        const int row = row0 + (e >= 2 ? 8 : 0);
        const int col = k0 + nt * 8 + t * 2 + (e & 1);
        if (!visible(row, col, Lk, causal, window)) s[nt * 4 + e] = -INFINITY;
      }
      mx[e >> 1] = fmaxf(mx[e >> 1], s[nt * 4 + e]);
    }
  float mu[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float m_new = fmaxf(m[r], mx[r] * scale_log2);
    mu[r] = m_new == -INFINITY ? 0.f : m_new;
    alpha[r] = FAST_EXP ? exp2_approx(m[r] - mu[r]) : exp2f(m[r] - mu[r]);
    m[r] = m_new;
    l[r] *= alpha[r];
  }
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float x = fmaf(s[nt * 4 + e], scale_log2, -mu[e >> 1]);
      const float p = FAST_EXP ? exp2_approx(x) : exp2f(x);
      s[nt * 4 + e] = p;
      l[e >> 1] += p;
    }
}

template <int NO>
__device__ __forceinline__ void rescale_rows(float* o, const float* alpha) {
#pragma unroll
  for (int j = 0; j < NO; ++j) {
    o[j * 4 + 0] *= alpha[0]; o[j * 4 + 1] *= alpha[0];
    o[j * 4 + 2] *= alpha[1]; o[j * 4 + 3] *= alpha[1];
  }
}

// ----------------------------------------------------------------- bf16
//
// wgmma wrappers: PTX names every accumulator register, so there is one
// wrapper per N.  The RS form (A from registers) takes B transposed
// (MN-major, imm-trans-b = 1).

// S (64 x 64) += A (64 x 16) . B (16 x 64), A and B K-major in shared memory
__device__ __forceinline__ void wgmma_ss_n64(float* d, uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs_n16(float* d, const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_n32(float* d, const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_n48(float* d, const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %29, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23}, "
      "{%24, %25, %26, %27}, %28, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_n64(float* d, const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_n80(float* d, const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39}, "
      "{%40, %41, %42, %43}, %44, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_n96(float* d, const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47}, "
      "{%48, %49, %50, %51}, %52, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_n112(float* d, const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %61, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n112k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55}, "
      "{%56, %57, %58, %59}, %60, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_n128(float* d, const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int N>
__device__ __forceinline__ void wgmma_rs(float* d, const uint32_t* a, uint64_t db) {
  if constexpr (N == 16) wgmma_rs_n16(d, a, db);
  else if constexpr (N == 32) wgmma_rs_n32(d, a, db);
  else if constexpr (N == 48) wgmma_rs_n48(d, a, db);
  else if constexpr (N == 64) wgmma_rs_n64(d, a, db);
  else if constexpr (N == 80) wgmma_rs_n80(d, a, db);
  else if constexpr (N == 96) wgmma_rs_n96(d, a, db);
  else if constexpr (N == 112) wgmma_rs_n112(d, a, db);
  else wgmma_rs_n128(d, a, db);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>   // wait until at most N committed groups are still running
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// Pins accumulator registers in place around an asynchronous wgmma, so no
// read or write of them moves across its issue or its wait.
template <int N>
__device__ __forceinline__ void fence_regs(float* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// The same for A-operand registers, which a running wgmma still reads.
template <int N>
__device__ __forceinline__ void fence_regs32(uint32_t* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// wgmma shared-memory descriptor, no swizzle: start address, leading- and
// stride-dimension byte offsets (all in 16-byte units).
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) | (static_cast<uint64_t>(sbo >> 4) << 32);
}

// mbarrier and TMA (cp.async.bulk.tensor) helpers.  One thread arms a
// stage's barrier with the bytes it expects and issues the stage's copies;
// every consumer waits on the barrier's phase parity.
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}

// Copy the (8 columns x box rows) box at (column c, head h, row r, batch b)
// of a (b, L, h, hd) tensor map to shared memory: box rows of 16 bytes each,
// one after the other.  Rows past L and columns past hd arrive as zeros.
__device__ __forceinline__ void tma_load_box(uint32_t dst, const CUtensorMap* map, int c, int h,
                                             int r, int b, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5}], [%6];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c), "r"(h), "r"(r), "r"(b), "r"(bar)
      : "memory");
}

// Rows [row0, row0 + rows) of one head into a core-matrix tile of rows x HD:
// column block cb (8 columns) is one box of `rows` 16-byte rows at byte
// cb * rows * 16, so core matrix (cb, r / 8) sits at (cb * rows/8 + r/8) * 128.
template <int HD>
__device__ __forceinline__ void tma_load_tile(uint32_t dst, const CUtensorMap* map, int rows,
                                              int head, int row0, int batch, uint32_t bar) {
#pragma unroll
  for (int cb = 0; cb < HD / 8; ++cb)
    tma_load_box(dst + cb * rows * 16, map, cb * 8, head, row0, batch, bar);
}

template <int HD>   // head_dim padded to a multiple of 16; hd <= HD is the real one
__global__ void __launch_bounds__(256, HD <= 80 ? 2 : 1)
flash_bf16_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                  const __grid_constant__ CUtensorMap tv, __nv_bfloat16* __restrict__ out,
                  int Lq, int Lk, int H, int hd, int causal, int window, float scale_log2,
                  float cap, float cap_in) {
  constexpr int Q_BYTES = BQ16 * HD * 2;
  constexpr int TILE_BYTES = BKV * HD * 2;
  constexpr int NO = HD / 8;   // n-tiles of O
  extern __shared__ __align__(1024) unsigned char smem[];
  const uint32_t sq = smem_u32(smem);
  const uint32_t skv = sq + Q_BYTES;                              // stage s: K tile, then V tile
  const uint32_t bars = skv + STAGES16 * 2 * TILE_BYTES;          // Q's barrier, then one a stage

  const int bh = blockIdx.x;
  const int bi = bh / H, hi = bh % H;
  const long long rs = static_cast<long long>(H) * hd;   // row stride
  __nv_bfloat16* O = out + (static_cast<long long>(bi) * Lq * H + hi) * hd;

  // the warpgroup index broadcast from lane 0, so that ptxas sees it (and the
  // branches around each wgmma) as uniform and keeps the wgmmas pipelined
  const int tid = threadIdx.x, wg = __shfl_sync(0xffffffffu, tid / 128, 0);
  const int warp = (tid % 128) / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ16;   // longest causal tiles first
  const int qw0 = q0 + wg * 64;                          // this warpgroup's first row
  const int row0 = qw0 + warp * 16 + g;                  // this thread's rows: row0, row0 + 8

  int kt_lo, kt_hi;
  k_tile_range(q0, min(q0 + BQ16, Lq) - 1, Lk, causal, window, &kt_lo, &kt_hi);
  const int n_tiles = kt_hi - kt_lo;
  auto load_kv = [&](int i) {        // one thread: arm stage i's barrier, copy K and V
    const uint32_t st = skv + (i % STAGES16) * 2 * TILE_BYTES;
    const uint32_t bar = bars + 8 * (1 + i % STAGES16);
    const int k0 = (kt_lo + i) * BKV;
    mbar_expect_tx(bar, 2 * TILE_BYTES);
    tma_load_tile<HD>(st, &tk, BKV, hi, k0, bi, bar);
    tma_load_tile<HD>(st + TILE_BYTES, &tv, BKV, hi, k0, bi, bar);
  };

  if (tid == 0) {
    for (int b = 0; b <= STAGES16; ++b) mbar_init(bars + 8 * b, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(bars, Q_BYTES);
    tma_load_tile<HD>(sq, &tq, BQ16, hi, q0, bi, bars);
    for (int i = 0; i < STAGES16 - 1 && i < n_tiles; ++i) load_kv(i);
  }

  // this warpgroup's own run of tiles [wlo, whi) within the block's: those
  // holding a key visible to one of its 64 rows
  int wlo, whi;
  k_tile_range(qw0, qw0 + 63, Lk, causal, window, &wlo, &whi);
  wlo = max(wlo, kt_lo) - kt_lo;
  whi = min(whi, kt_hi) - kt_lo;

  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};
  float alpha[2];
  float o[NO * 4];
  float s[32];                       // S of the current tile, then its p
  uint32_t pa[4][4];                 // p in bf16: the A operand of P V
#pragma unroll
  for (int i = 0; i < NO * 4; ++i) o[i] = 0.f;
  // Q (128 x HD tile): k16 step kk starts at column block 2kk; the next 8
  // columns lie 16 core matrices on, the next 8 rows one core matrix on
  const uint32_t q_base = sq + wg * 8 * 128;
  // S = Q K^T, both K-major; K's next 8 columns lie 8 core matrices on
  auto issue_qk = [&](int i) {
    const uint32_t k_base = skv + (i % STAGES16) * 2 * TILE_BYTES;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      wgmma_ss_n64(s, make_desc(q_base + kk * 4096, 16 * 128, 128),
                   make_desc(k_base + kk * 2048, 8 * 128, 128), kk > 0);
    wgmma_commit();
  };
  auto softmax = [&](int i) {
    const int k0 = (kt_lo + i) * BKV;
    online_softmax<8, true>(s, m, l, alpha, tile_mask(qw0, 64, k0, Lk, causal, window).full,
                            row0, k0, t, Lk, causal, window, scale_log2, cap, cap_in);
  };
  // S's n-tiles 2kk, 2kk+1 are the A fragment of keys 16kk..16kk+15
  auto pack_p = [&]() {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      pa[kk][0] = pack_bf16(s[8 * kk + 0], s[8 * kk + 1]);
      pa[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
      pa[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
      pa[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
    }
  };
  auto stage_wait = [&](int i) {
    mbar_wait(bars + 8 * (1 + i % STAGES16), (i / STAGES16) & 1);
  };
  mbar_wait(bars, 0);

  for (int i = 0; i < n_tiles; ++i) {
    __syncthreads();                         // every thread is done with tile i-1: its stage is free
    if (tid == 0 && i + STAGES16 - 1 < n_tiles) load_kv(i + STAGES16 - 1);
    if (i < wlo || i >= whi) continue;       // uniform over the warpgroup
    stage_wait(i);
    fence_regs<32>(s);
    wgmma_fence();
    issue_qk(i);
    wgmma_wait<0>();
    fence_regs<32>(s);
    softmax(i);
    rescale_rows<NO>(o, alpha);
    pack_p();
    // O += P V: V is MN-major, the next 8 keys one core matrix on (LBO), the
    // next 8 columns 8 core matrices on (SBO)
    const uint32_t v_base = skv + (i % STAGES16) * 2 * TILE_BYTES + TILE_BYTES;
    fence_regs<NO * 4>(o);
    fence_regs32<16>(&pa[0][0]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs<HD>(o, pa[kk], make_desc(v_base + kk * 2 * 128, 128, 8 * 128));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs<NO * 4>(o);
    fence_regs32<16>(&pa[0][0]);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    l[r] = 1.f / fmaxf(l[r], 1e-30f);
  }
#pragma unroll
  for (int j = 0; j < NO; ++j) {
    const int c = j * 8 + t * 2;
    if (c >= hd) continue;
    if (row0 < Lq)
      *reinterpret_cast<uint32_t*>(O + row0 * rs + c) =
          pack_bf16(o[4 * j] * l[0], o[4 * j + 1] * l[0]);
    if (row0 + 8 < Lq)
      *reinterpret_cast<uint32_t*>(O + (row0 + 8) * rs + c) =
          pack_bf16(o[4 * j + 2] * l[1], o[4 * j + 3] * l[1]);
  }
}

// ------------------------------------------------------------------ f32

__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(x));
  const float rest = x - __uint_as_float(hi);
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(lo) : "f"(rest));
}

__device__ __forceinline__ void mma_tf32(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a b in 3xTF32: the small cross terms first, then hi * hi
__device__ __forceinline__ void mma_3xtf32(float* c, const uint32_t* ah, const uint32_t* al,
                                           const uint32_t* bh, const uint32_t* bl) {
  mma_tf32(c, al, bh[0], bh[1]);
  mma_tf32(c, ah, bl[0], bl[1]);
  mma_tf32(c, ah, bh[0], bh[1]);
}

// Copy rows [row0, row0 + rows) of an (L, hd) f32 matrix with row stride rs
// into a row-major tile with row stride HD + 4, zero-filled past L and hd.
template <int HD>
__device__ __forceinline__ void load_tile_f32(float* dst, const float* src, int row0, int rows,
                                              int L, long long rs, int hd, bool vec, int tid,
                                              int nthreads) {
  constexpr int S = HD + 4;
  if (vec) {
    constexpr int C4 = HD / 4;
    for (int e = tid; e < rows * C4; e += nthreads) {
      const int r = e / C4, c = (e % C4) * 4;
      const bool in = row0 + r < L && c < hd;
      cp_async16(dst + r * S + c, in ? src + (row0 + r) * rs + c : src, in ? 16 : 0);
    }
  } else {
    for (int e = tid; e < rows * HD; e += nthreads) {
      const int r = e / HD, c = e % HD;
      const bool in = row0 + r < L && c < hd;
      cp_async4(dst + r * S + c, in ? src + (row0 + r) * rs + c : src, in ? 4 : 0);
    }
  }
}

template <int HD>   // head_dim padded to a multiple of 16
__global__ void __launch_bounds__(128)
flash_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ out, int Lq, int Lk, int H,
                 int hd, int causal, int window, float scale_log2, float cap, float cap_in,
                 int vec) {
  constexpr int S = HD + 4;          // shared row stride (floats)
  constexpr int TILE = BKV * S;
  constexpr int NO = HD / 8;
  extern __shared__ __align__(16) float smem32[];
  float* sq = smem32;                // BQ32 x S
  float* skv = sq + BQ32 * S;        // stage s: K tile, then V tile

  const int bh = blockIdx.x;
  const int bi = bh / H, hi = bh % H;
  const long long rs = static_cast<long long>(H) * hd;
  const float* Q = q + (static_cast<long long>(bi) * Lq * H + hi) * hd;
  const float* K = k + (static_cast<long long>(bi) * Lk * H + hi) * hd;
  const float* V = v + (static_cast<long long>(bi) * Lk * H + hi) * hd;
  float* O = out + (static_cast<long long>(bi) * Lq * H + hi) * hd;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ32;
  const int qw0 = q0 + warp * 16;    // this warp's first row
  const int row0 = qw0 + g;

  int kt_lo, kt_hi;
  k_tile_range(q0, min(q0 + BQ32, Lq) - 1, Lk, causal, window, &kt_lo, &kt_hi);
  const int n_tiles = kt_hi - kt_lo;
  auto load_kv = [&](int i) {
    float* st = skv + (i % STAGES32) * 2 * TILE;
    const int k0 = (kt_lo + i) * BKV;
    load_tile_f32<HD>(st, K, k0, BKV, Lk, rs, hd, vec != 0, tid, 128);
    load_tile_f32<HD>(st + TILE, V, k0, BKV, Lk, rs, hd, vec != 0, tid, 128);
  };

  load_tile_f32<HD>(sq, Q, q0, BQ32, Lq, rs, hd, vec != 0, tid, 128);
#pragma unroll
  for (int s = 0; s < STAGES32 - 1; ++s) {
    if (s < n_tiles) load_kv(s);
    cp_async_commit();
  }

  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};
  float o[NO * 4];
#pragma unroll
  for (int i = 0; i < NO * 4; ++i) o[i] = 0.f;

  for (int i = 0; i < n_tiles; ++i) {
    cp_async_wait<STAGES32 - 2>();
    __syncthreads();
    if (i + STAGES32 - 1 < n_tiles) load_kv(i + STAGES32 - 1);
    cp_async_commit();

    const int k0 = (kt_lo + i) * BKV;
    const TileMask tm = tile_mask(qw0, 16, k0, Lk, causal, window);
    if (tm.empty) continue;          // uniform over the warp
    const float* sk = skv + (i % STAGES32) * 2 * TILE;
    const float* sv = sk + TILE;

    float s[32];
#pragma unroll
    for (int e = 0; e < 32; ++e) s[e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < HD / 8; ++kk) {
      const float* qp = sq + (warp * 16 + g) * S + kk * 8 + t;
      uint32_t ah[4], al[4];
      split_tf32(qp[0], ah[0], al[0]);
      split_tf32(qp[8 * S], ah[1], al[1]);
      split_tf32(qp[4], ah[2], al[2]);
      split_tf32(qp[8 * S + 4], ah[3], al[3]);
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const float* kp = sk + (nt * 8 + g) * S + kk * 8 + t;
        uint32_t bh[2], bl[2];
        split_tf32(kp[0], bh[0], bl[0]);
        split_tf32(kp[4], bh[1], bl[1]);
        mma_3xtf32(s + nt * 4, ah, al, bh, bl);
      }
    }

    float alpha[2];
    online_softmax<8, false>(s, m, l, alpha, tm.full, row0, k0, t, Lk, causal, window,
                             scale_log2, cap, cap_in);
    rescale_rows<NO>(o, alpha);

    // O += P V over the 8 key blocks of 8: k slot t is key 2t, slot t + 4 key 2t + 1
#pragma unroll
    for (int kb = 0; kb < 8; ++kb) {
      uint32_t ph[4], pl[4];
      split_tf32(s[kb * 4 + 0], ph[0], pl[0]);
      split_tf32(s[kb * 4 + 2], ph[1], pl[1]);
      split_tf32(s[kb * 4 + 1], ph[2], pl[2]);
      split_tf32(s[kb * 4 + 3], ph[3], pl[3]);
      const float* vp = sv + (kb * 8 + 2 * t) * S + g;
#pragma unroll
      for (int j = 0; j < NO; ++j) {
        uint32_t bh[2], bl[2];
        split_tf32(vp[j * 8], bh[0], bl[0]);
        split_tf32(vp[S + j * 8], bh[1], bl[1]);
        mma_3xtf32(o + j * 4, ph, pl, bh, bl);
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    l[r] = 1.f / fmaxf(l[r], 1e-30f);
  }
#pragma unroll
  for (int j = 0; j < NO; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = row0 + (e >= 2 ? 8 : 0);
      const int c = j * 8 + t * 2 + (e & 1);
      if (row < Lq && c < hd) O[row * rs + c] = o[4 * j + e] * l[e >> 1];
    }
  }
}

// cuTensorMapEncodeTiled, looked up through the CUDA runtime (no link
// against libcuda); null when it is not available.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled tensor_map_encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                                    cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// Tensor map of a (b, L, h, hd) bf16 tensor read in place, in boxes of
// 8 columns x `rows` rows of one head; out-of-range elements read as zero.
int bf16_map(CUtensorMap* map, const void* base, int b, int L, int H, int hd, int rows) {
  const EncodeTiled encode = tensor_map_encoder();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(hd), static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(L), static_cast<cuuint64_t>(b)};
  const cuuint64_t strides[3] = {2ull * hd, 2ull * H * hd, 2ull * L * H * hd};
  const cuuint32_t box[4] = {8, 1, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base),
                            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

template <int HD>
int launch_bf16(const void* q, const void* k, const void* v, void* out, int b, int Lq, int Lk,
                int H, int hd, int causal, int window, float scale_log2, float cap,
                float cap_in, cudaStream_t stream) {
  const int smem = BQ16 * HD * 2 + STAGES16 * 2 * BKV * HD * 2 + 8 * (1 + STAGES16);
  CUtensorMap tq, tk, tv;
  int err = bf16_map(&tq, q, b, Lq, H, hd, BQ16);
  if (err == 0) err = bf16_map(&tk, k, b, Lk, H, hd, BKV);
  if (err == 0) err = bf16_map(&tv, v, b, Lk, H, hd, BKV);
  if (err != 0) return err;
  const cudaError_t attr = cudaFuncSetAttribute(
      flash_bf16_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  dim3 grid(b * H, (Lq + BQ16 - 1) / BQ16);
  flash_bf16_kernel<HD><<<grid, 256, smem, stream>>>(tq, tk, tv, static_cast<__nv_bfloat16*>(out),
                                                     Lq, Lk, H, hd, causal, window, scale_log2,
                                                     cap, cap_in);
  return static_cast<int>(cudaGetLastError());
}

template <int HD>
int launch_f32(const void* q, const void* k, const void* v, void* out, int b, int Lq, int Lk,
               int H, int hd, int causal, int window, float scale_log2, float cap,
               float cap_in, cudaStream_t stream) {
  const int smem = (BQ32 + STAGES32 * 2 * BKV) * (HD + 4) * 4;
  cudaError_t err = cudaFuncSetAttribute(flash_f32_kernel<HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const uintptr_t bits = reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                         reinterpret_cast<uintptr_t>(v);
  const int vec = hd % 4 == 0 && (bits & 15) == 0;
  dim3 grid(b * H, (Lq + BQ32 - 1) / BQ32);
  flash_f32_kernel<HD><<<grid, 128, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(out), Lq, Lk, H, hd, causal, window, scale_log2, cap, cap_in, vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// 1 when the kernel takes this (dtype, head_dim): dtype 0 = f32 (head_dim up
// to 128), 1 = bf16 (head_dim a multiple of 8 up to 128).
extern "C" int repro_flash_supports(int dtype, int hd) {
  if (dtype == 1) return hd > 0 && hd % 8 == 0 && hd <= MAX_HD;
  return dtype == 0 && hd > 0 && hd <= MAX_HD;
}

// Query rows per block of each dtype's kernel (the wrapper bounds the grid).
extern "C" int repro_flash_query_tile(int dtype) { return dtype == 1 ? BQ16 : BQ32; }

// q (b, Lq, h, hd), k and v (b, Lk, h, hd), out (b, Lq, h, hd): contiguous on
// the device, all f32 (dtype 0) or all bf16 (dtype 1).  Query i sees key j
// when (!causal || j <= i) and (window <= 0 || j > i - window).  softcap > 0
// caps the scaled scores at softcap * tanh(s / softcap) before the mask (0:
// off).  Returns the cudaError_t of the launch (0 on success).
extern "C" int repro_flash_attention(const void* q, const void* k, const void* v, void* out,
                                     int dtype, int b, int Lq, int Lk, int h, int hd,
                                     int causal, int window, float softcap, void* stream_ptr) {
  if (b <= 0 || Lq <= 0 || h <= 0) return 0;
  const long long q_tiles = (Lq + repro_flash_query_tile(dtype) - 1) / repro_flash_query_tile(dtype);
  if (!repro_flash_supports(dtype, hd) || Lk <= 0 || q_tiles > 65535 ||
      static_cast<long long>(b) * h > 0x7fffffffLL || !(softcap >= 0.f))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const float scale = 1.f / sqrtf(static_cast<float>(hd));
  const float cap = softcap, cap_in = softcap > 0.f ? scale / softcap : 0.f;
  const float scale_log2 = softcap > 0.f ? LOG2E : LOG2E / sqrtf(static_cast<float>(hd));
#define REPRO_FLASH_CASE(n)                                                                   \
  case n:                                                                                     \
    return dtype == 1 ? launch_bf16<16 * n>(q, k, v, out, b, Lq, Lk, h, hd, causal, window,   \
                                            scale_log2, cap, cap_in, stream)                  \
                      : launch_f32<16 * n>(q, k, v, out, b, Lq, Lk, h, hd, causal, window,    \
                                           scale_log2, cap, cap_in, stream);
  switch ((hd + 15) / 16) {
    REPRO_FLASH_CASE(1) REPRO_FLASH_CASE(2) REPRO_FLASH_CASE(3) REPRO_FLASH_CASE(4)
    REPRO_FLASH_CASE(5) REPRO_FLASH_CASE(6) REPRO_FLASH_CASE(7)
    default:
      return dtype == 1 ? launch_bf16<128>(q, k, v, out, b, Lq, Lk, h, hd, causal, window,
                                           scale_log2, cap, cap_in, stream)
                        : launch_f32<128>(q, k, v, out, b, Lq, Lk, h, hd, causal, window,
                                          scale_log2, cap, cap_in, stream);
  }
#undef REPRO_FLASH_CASE
}
