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
// Two kernels; the launcher's plan picks one by the table's size.
//
// reach_group_kernel (the plan's first choice): under left multiplication
// P' = N[x] P every column of P evolves on its own, so one thread walks one
// column j of one chunk, holding its state set as W = lp/32 words in
// registers: one step is col' = OR over the set bits s of col of column s of
// N[x].  No barrier and no exchange between threads while walking.  The
// walk reads a group table ("Four Russians"): for every class x, every g-bit
// group of source states and every value v of that group, T[x][group][v] is
// the OR of the matching columns of N[x], so a step is lp/g lookups of W
// words, g = 4 or 2 (g = 1 needs as many bytes as g = 2 for twice the
// lookups).  The launcher builds T once per call from N; the block copies all
// of it into shared memory (g = 4: TRAFFIC 19 classes at lp = 64, 58 KB;
// e125 4 classes at lp = 288, 166 KB).  An entry is W | 1 words long, odd,
// so the 16 entries of a group lie in 16 distinct banks and a warp's lookups
// (one class, one group, 32 values of v) are free of conflicts.  A warp walks
// 32 columns of one chunk; the chunk's class ids come in 32 at a time, one
// coalesced load (the next 32 prefetched) shared out by __shfl_sync.  Warps
// take (chunk, 32-column) units in turn across a grid of one or a few blocks
// an SM, interleaved so that every SM gets nearly the same number.  Shared
// memory bounds it: each lookup reads W words, lp^3 / (32 g) words a step
// over the chunk's lp columns.
//
// reach_strip_kernel (tables that no group width fits, up to lp = 928): the
// port's first design.  The grid is (chunks) x (lp / 32 column strips), and
// each block walks its chunk's k class ids itself, keeping only its
// 32-column strip as bits (column j = W words over the rows) and N as
// row-packed words, so one step is P'[i][j] = (OR_w Nr[x][i][w] & P[j][w])
// != 0.  One
// warp produces one word of one column (lane = row), gathered with
// __ballot_sync; N[x_{t+1}] is copied into shared memory while step t
// computes, one __syncthreads a step.
//
// Both write the product as f32 {0,1}, bit for bit the product of the plain
// version.  PAD steps (N = identity) are folded like any other step.
//
// The live window (kernels/window.py; the fleet's buckets padded past their
// live states): where every table is block-diagonal, N[x] = diag(A_x, D_x)
// with A_x over the lw live states and D_x in {0, I}, a chunk's product is
// diag(prod A, prod D), and prod D = I exactly when every step's class has
// D = I.  The group kernel then walks the lw live columns over a table of the
// lw live states (e125's bucket at lp = 512: lw = 288, 166 KB at g = 4, the
// solo e125 table, where one of all 512 states would take 557 KB), and
// before it reach_pad_kernel writes the rest of each product, one warp a
// (chunk, 32-row band) unit over a grid of its own, float4 stores along
// whole rows: zeros right of the live columns in the live rows, and in each
// padded row zeros but its diagonal entry, the chunk's flag.  A warp finds
// the flag from the chunk's ids, 32 at a time, and a per-class bit (ident).
// (Inside the group kernel the same stores made one width spill.)  The
// strip kernel has no window: it walks every state.
//
// The tenant axis (the fleet's bucket dispatch, core/fleet.py): one launch
// may serve T automata of one bucket shape, their tables stacked (T, A+1,
// ...) and their chunks in T equal runs of cpt = n_chunks / T, chunk c
// reading tenant c / cpt's table.  The group kernel's grid is (blocks a
// tenant, T): a block builds only its own tenant's table in shared memory
// and its warps take that tenant's units in turn, so a bucket of T tenants
// needs no more shared memory a block than one tenant.  The strip kernel
// finds its chunk's table at offset (chunk / cpt) in the stack.  T = 1 is a
// plain launch over one table.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int STRIP = 32;
constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;

__global__ void __launch_bounds__(THREADS)
reach_strip_kernel(const uint32_t* __restrict__ nr, const int32_t* __restrict__ ids,
                   float* __restrict__ out, int k, int lp, int W, int cpt,
                   long long table_words) {
  extern __shared__ uint32_t smem[];
  const int NW = lp * W;
  uint32_t* sN = smem;               // [2][lp * W]    row-packed N[x_t]
  uint32_t* sP = smem + 2 * NW;      // [2][STRIP * W] bit columns of the strip

  const long long chunk = blockIdx.x;
  nr += chunk / cpt * table_words;   // this chunk's tenant's table
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

constexpr int MAX_GROUP_W = 16;     // lw <= 512 on the group kernel
constexpr int GROUP_THREADS = 1024;

// The padded part of the products (n_chunks, lp, lp) beyond the lw live
// states, one warp a (chunk, band of 32 rows) unit.  ident (tenants,
// n_classes): 1 where the class is the identity on the padded states; chunk
// c is tenant c / cpt's.
__global__ void reach_pad_kernel(const int32_t* __restrict__ ids,
                                 const int32_t* __restrict__ ident, float* __restrict__ out,
                                 int n_chunks, int k, int lp, int lw, int n_classes, int cpt) {
  const int lane = threadIdx.x & 31;
  const int bands = lp / 32;
  const long long units = static_cast<long long>(n_chunks) * bands;
  const long long warps = static_cast<long long>(gridDim.x) * (blockDim.x >> 5);
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  for (long long u = static_cast<long long>(blockIdx.x) * (blockDim.x >> 5) + (threadIdx.x >> 5);
       u < units; u += warps) {
    const long long chunk = u / bands;
    const int r0 = static_cast<int>(u % bands) * 32;
    float* o = out + chunk * lp * lp;
    if (r0 < lw) {                     // live rows: columns lw .. lp - 1
      const int n4 = (lp - lw) / 4;
      for (int e = lane; e < 32 * n4; e += 32)
        reinterpret_cast<float4*>(o + static_cast<long long>(r0 + e / n4) * lp + lw)[e % n4] =
            zero;
      continue;
    }
    // padded rows: 1 on the diagonal where every step's class has D = I
    const int32_t* cid = ids + chunk * k;
    const int32_t* flags = ident + chunk / cpt * n_classes;
    bool flag = true;
    for (int t0 = 0; t0 < k && flag; t0 += 32) {
      const int t = t0 + lane;
      flag = __all_sync(0xffffffffu, t >= k || __ldg(flags + __ldg(cid + t)) != 0);
    }
    const float d = flag ? 1.f : 0.f;
    const int n4 = lp / 4;
    for (int e = lane; e < 32 * n4; e += 32) {
      const int r = r0 + e / n4;
      const int c = 4 * (e % n4);
      reinterpret_cast<float4*>(o + static_cast<long long>(r) * lp)[e % n4] =
          make_float4(c == r ? d : 0.f, c + 1 == r ? d : 0.f, c + 2 == r ? d : 0.f,
                      c + 3 == r ? d : 0.f);
    }
  }
}

// T: (tenants, t_words) words, tenant t's (A+1, lw/G, 2^G, W|1) group table
// of the lw = 32 W live states in its row (t_words a multiple of 4); ids
// (tenants * n_chunks, k); out (tenants * n_chunks, lp, lp), of which it
// writes the live block [0, lw)^2; n_chunks is a tenant's.  Block (x, t)
// serves tenant t.  At least one block an SM lets ptxas give a thread 64
// registers, so that a column's words stay in them (left to itself it chose
// 32 at W = 9, and spilled).
template <int W, int G>
__global__ void __launch_bounds__(GROUP_THREADS, 1)
reach_group_kernel(const uint32_t* __restrict__ T, int t_words, const int32_t* __restrict__ ids,
                   float* __restrict__ out, int n_chunks, int k, int lp) {
  extern __shared__ __align__(16) uint32_t sT[];
  T += static_cast<long long>(blockIdx.y) * t_words;
  ids += static_cast<long long>(blockIdx.y) * n_chunks * k;
  out += static_cast<long long>(blockIdx.y) * n_chunks * lp * lp;
  constexpr int WS = W | 1;           // entry stride: odd, so distinct v -> distinct banks
  constexpr int V = 1 << G;
  constexpr int GPW = 32 / G;         // groups in a word
  for (int e = threadIdx.x; e < t_words / 4; e += blockDim.x)
    reinterpret_cast<uint4*>(sT)[e] = reinterpret_cast<const uint4*>(T)[e];
  __syncthreads();

  constexpr int cls_stride = W * 32 / G * V * WS;
  const int lane = threadIdx.x & 31;
  const int warps_per_block = blockDim.x >> 5;
  const long long warps = static_cast<long long>(gridDim.x) * warps_per_block;
  // interleaved: the first warps of every block come first, so the units
  // left over after whole rounds spread over all SMs
  const long long gw = static_cast<long long>(threadIdx.x >> 5) * gridDim.x + blockIdx.x;
  const long long units = static_cast<long long>(n_chunks) * W;
  for (long long u = gw; u < units; u += warps) {
    const long long chunk = u / W;
    const int strip = static_cast<int>(u % W);
    uint32_t col[W];
#pragma unroll
    for (int w = 0; w < W; ++w) col[w] = w == strip ? 1u << lane : 0u;
    const int32_t* cid = ids + chunk * k;
    int idv = lane < k ? cid[lane] : 0;
    for (int t0 = 0; t0 < k; t0 += 32) {
      const int nxt = t0 + 32 + lane < k ? cid[t0 + 32 + lane] : 0;
      const int steps = k - t0 < 32 ? k - t0 : 32;
      for (int s = 0; s < steps; ++s) {
        const uint32_t* tb = sT + __shfl_sync(0xffffffffu, idv, s) * cls_stride;
        uint32_t nw[W];
#pragma unroll
        for (int i = 0; i < W; ++i) nw[i] = 0u;
        // word w of col is consumed from col[0], the rest shifted down, so
        // that the loop over words need not be unrolled
#pragma unroll 1
        for (int w = 0; w < W; ++w) {
          const uint32_t word = col[0];
#pragma unroll
          for (int i = 0; i + 1 < W; ++i) col[i] = col[i + 1];
          const uint32_t* gb = tb + w * (GPW * V * WS);
#pragma unroll
          for (int b = 0; b < GPW; ++b) {
            const uint32_t* e = gb + (b * V + ((word >> (b * G)) & (V - 1))) * WS;
#pragma unroll
            for (int i = 0; i < W; ++i) nw[i] |= e[i];
          }
        }
#pragma unroll
        for (int i = 0; i < W; ++i) col[i] = nw[i];
      }
      idv = nxt;
    }
    float* o = out + chunk * lp * lp + strip * 32 + lane;
#pragma unroll 1
    for (int w = 0; w < W; ++w) {
      const uint32_t word = col[0];
#pragma unroll
      for (int i = 0; i + 1 < W; ++i) col[i] = col[i + 1];
#pragma unroll
      for (int b = 0; b < 32; ++b)
        o[static_cast<long long>(32 * w + b) * lp] = (word >> b) & 1u ? 1.f : 0.f;
    }
  }
}

typedef void (*GroupKernel)(const uint32_t*, int, const int32_t*, float*, int, int, int);

template <int W>
GroupKernel group_kernel_g(int g) {
  return g == 4 ? &reach_group_kernel<W, 4> : g == 2 ? &reach_group_kernel<W, 2> : nullptr;
}

GroupKernel group_kernel(int W, int g) {
  switch (W) {
    case 1: return group_kernel_g<1>(g);
    case 2: return group_kernel_g<2>(g);
    case 3: return group_kernel_g<3>(g);
    case 4: return group_kernel_g<4>(g);
    case 5: return group_kernel_g<5>(g);
    case 6: return group_kernel_g<6>(g);
    case 7: return group_kernel_g<7>(g);
    case 8: return group_kernel_g<8>(g);
    case 9: return group_kernel_g<9>(g);
    case 10: return group_kernel_g<10>(g);
    case 11: return group_kernel_g<11>(g);
    case 12: return group_kernel_g<12>(g);
    case 13: return group_kernel_g<13>(g);
    case 14: return group_kernel_g<14>(g);
    case 15: return group_kernel_g<15>(g);
    case 16: return group_kernel_g<16>(g);
    default: return nullptr;
  }
}

}  // namespace

// The strip kernel.  nr (n_tenants, n_classes, lp, W) int32 row-packed N;
// ids (n_chunks, k) int32 class ids in [0, n_classes), in n_tenants equal
// runs; out (n_chunks, lp, lp) f32.  lp % 32 == 0, and 8 * W * (lp + 32)
// bytes of shared memory (lp <= 928).  Returns the cudaError_t of the launch
// (0 on success).
extern "C" int repro_reach_products(const uint32_t* nr, const int32_t* ids,
                                    float* out, int n_chunks, int k, int lp,
                                    int n_classes, int n_tenants, void* stream) {
  if (n_chunks <= 0) return 0;
  if (lp <= 0 || lp % 32 != 0 || n_tenants < 1 || n_chunks % n_tenants != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long smem = (2LL * lp * (lp / 32) + 2LL * STRIP * (lp / 32)) * 4;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        reach_strip_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(static_cast<unsigned>(n_chunks), static_cast<unsigned>(lp / STRIP));
  reach_strip_kernel<<<grid, THREADS, static_cast<size_t>(smem),
                 static_cast<cudaStream_t>(stream)>>>(nr, ids, out, k, lp, lp / 32,
                                                      n_chunks / n_tenants,
                                                      static_cast<long long>(n_classes) * lp *
                                                          (lp / 32));
  return static_cast<int>(cudaGetLastError());
}

// The group kernel.  T: the launcher's group tables, (n_tenants, t_words)
// int32 words, each tenant's (A+1, lw/g, 2^g, lw/32|1) table of its lw live
// states in its row (t_words a multiple of 4, all in one block's shared
// memory); ids (n_chunks, k) int32 class ids in [0, A], in n_tenants equal
// runs; out (n_chunks, lp, lp) f32; ident (n_tenants, n_classes) int32
// flags (1: the class is the identity on the states lw .. lp - 1), needed
// when lw < lp.  lp and lw multiples of 32, lw <= lp, lw <= 512, g in {2, 4},
// n_tenants <= 65535.  Returns the cudaError_t of the launch (0 on success).
extern "C" int repro_reach_group(const uint32_t* T, int t_words, const int32_t* ids, float* out,
                                 int n_chunks, int k, int lp, int g, int n_tenants, int lw,
                                 const int32_t* ident, int n_classes, void* stream) {
  if (n_chunks <= 0) return 0;
  const GroupKernel fn = lw > 0 && lw % 32 == 0 ? group_kernel(lw / 32, g) : nullptr;
  if (fn == nullptr || lp % 32 != 0 || lw > lp ||
      (lw < lp && (ident == nullptr || n_classes < 1)) || t_words % 4 != 0 || n_tenants < 1 ||
      n_tenants > 65535 || n_chunks % n_tenants != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int cpt = n_chunks / n_tenants;         // chunks a tenant
  const size_t smem = static_cast<size_t>(t_words) * 4;
  cudaError_t err = cudaFuncSetAttribute(reinterpret_cast<const void*>(fn),
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return static_cast<int>(err);
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return static_cast<int>(err);
  // about as many warps an SM as there are units (of every tenant) for it,
  // up to one full block; the resident blocks shared out over the tenants
  const long long units = static_cast<long long>(n_chunks) * (lw / 32);
  const long long tenant_units = static_cast<long long>(cpt) * (lw / 32);
  long long wpb = (units + sms - 1) / sms;
  wpb = wpb > tenant_units ? tenant_units : wpb;   // no more warps than a tenant has units
  wpb = wpb < 1 ? 1 : wpb > GROUP_THREADS / 32 ? GROUP_THREADS / 32 : wpb;
  const int threads = static_cast<int>(wpb) * 32;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, threads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  long long blocks = (tenant_units + wpb - 1) / wpb;
  long long cap = static_cast<long long>(sms) * per_sm / n_tenants;
  cap = cap < 1 ? 1 : cap;
  if (blocks > cap) blocks = cap;
  if (lw < lp) {                                // the padded part: 8 warps a block, 16 blocks an SM
    const long long pad_units = static_cast<long long>(n_chunks) * (lp / 32);
    long long pad_blocks = (pad_units + 7) / 8;
    pad_blocks = pad_blocks < 16LL * sms ? pad_blocks : 16LL * sms;
    reach_pad_kernel<<<static_cast<unsigned>(pad_blocks), 256, 0,
                       static_cast<cudaStream_t>(stream)>>>(ids, ident, out, n_chunks, k, lp, lw,
                                                            n_classes, cpt);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(static_cast<unsigned>(blocks), static_cast<unsigned>(n_tenants));
  fn<<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(T, t_words, ids, out, cpt, k,
                                                                 lp);
  return static_cast<int>(cudaGetLastError());
}
