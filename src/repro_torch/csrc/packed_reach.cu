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
//     R'[j] = OR over the set bits s of R[j] of Np[x][s],
// where row s of Np[x] is the packed target set of source s (the reference's
// pack_transition_table orientation, i.e. N transposed, not K1's row-packed
// N).  K4 seeds R with the packed identity over n_rows = lp rows, so R ends
// as the chunk product; K5 seeds R from R0, the S gathered feasible-start
// rows of the sparse backend.  Both share each kernel below.
//
// Bound on this card: per chunk the k steps are a chain that cannot be split,
// against ids, one (A+1, lp, W) table and the rows in and out in device
// memory.  So operations and step latency bound it, not bytes.
//
// Two kernels; the launchers' plan (kernels/packed_reach.py) picks one by the
// table's size.
//
// packed_walk_kernel (the plan's first choice), a group-table row walk, the
// design of K1's group kernel (csrc/reach.cu) with rows for columns: a row of
// R is exactly the state set that K1 walks as a column.  For every class x,
// every g-bit group of source states and every value v of that group,
// T[x][group][v] is the OR of Np[x][group*g + b] over the set bits b of v,
// W | 1 words (odd, so the 2^g entries of a group lie in distinct banks).
// Each block builds all of T into its shared memory from Np, with one
// barrier, and keeps it for the whole launch (g = 4: TRAFFIC 19 classes at
// lp = 64, 58 KB; e125 4 classes at lp = 288, 166 KB).  One lane owns one
// row of one chunk with its W words in registers; a step is lp/g lookups of
// W words, ORed, with no barrier and no exchange between lanes.  When a
// chunk has fewer than 32 rows (K5 on TRAFFIC: S = 8), a warp packs
// 32 / rows chunks' rows (4 chunks x 8 rows), and each lane looks up its own
// chunk's class; the class stride is padded so that the same v of the
// classes of a warp's chunks lands in distinct banks.  Class ids come in by a
// coalesced load, the next round prefetched, and are shared out by
// __shfl_sync: a round covers 32 / (chunks a warp) steps of each chunk.
// Warps take (chunk group, 32-row strip) units in turn across one or a few
// blocks an SM, interleaved so that every SM gets nearly the same number.
// Shared memory bounds it, rows x steps x lp/g lookups x W words, where
// enough warps share an SM; with two (K5 on TRAFFIC) the latency of the
// chain of steps does.
//
// packed_fold_kernel (tables that no group width fits, up to lp = 960): the
// port's first design.  The grid is (chunks) x (row groups).  A thread owns
// one output word v of one row j: it walks the set bits of R[j] (read from
// shared memory, the same words for the W threads of a row) and ORs word v
// of the selected table rows.  N[x_{t+1}] is copied into shared memory while
// step t computes, and the rows are double-buffered too, so each step costs
// one __syncthreads.
//
// Both write the packed (n_chunks, n_rows, W) words of the plain version.
// PAD steps (the identity) are folded like any other step.
//
// The tenant axis (the fleet's bucket dispatch, core/fleet.py), as in K1
// (csrc/reach.cu): T automata of one bucket shape, Np stacked (T, A+1, lp,
// W), their chunks (and R0 and outputs) in T equal runs of cpt.  The walk
// kernel's grid is (blocks a tenant, T): a block builds its own tenant's
// table and walks that tenant's chunks, so the chunks a warp packs below 32
// rows are always one tenant's.  The fold kernel reads chunk c's steps from
// tenant c / cpt's table.  T = 1 is a plain launch.
//
// Limits, checked by the launchers: lp % 32 == 0; the walk needs lp <= 512
// and its table in one block's shared memory (232448 bytes); the fold needs
// 8 * lp * W + 8 * (rows per block) * W bytes of it, which holds for
// lp <= 960; K5 needs S <= lp.

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
                   int k, int lp, int W, int n_rows, int rpb, int cpt, long long table_words) {
  extern __shared__ uint32_t smem[];
  const int NW = lp * W;
  const int RW = rpb * W;
  uint32_t* sN = smem;             // [2][lp * W]   packed rows of N[x_t]
  uint32_t* sR = smem + 2 * NW;    // [2][rpb * W]  this block's running rows

  const long long chunk = blockIdx.x;
  np += chunk / cpt * table_words;   // this chunk's tenant's table
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

// Shared memory one block of the fold kernel needs for lp states and n_rows
// rows (bytes; kernels/packed_reach.py's fold_smem_bytes); above 232448 the
// kernel cannot launch on Hopper.
long long fold_smem_bytes(int lp, int n_rows) {
  const int W = lp / 32;
  const long long rpb = rows_per_block(W, n_rows);
  return (2LL * lp * W + 2LL * rpb * W) * 4;
}

int launch_fold(const uint32_t* np, const int32_t* ids, const uint32_t* r0,
                uint32_t* out, int n_chunks, int k, int lp, int n_rows, int n_classes,
                int n_tenants, void* stream) {
  if (n_chunks <= 0 || n_rows <= 0) return 0;
  if (lp <= 0 || lp % 32 != 0 || k < 0 || n_tenants < 1 || n_chunks % n_tenants != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int W = lp / 32;
  if (W > THREADS) return static_cast<int>(cudaErrorInvalidValue);
  const int rpb = rows_per_block(W, n_rows);
  const long long smem = fold_smem_bytes(lp, n_rows);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        packed_fold_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(static_cast<unsigned>(n_chunks),
                  static_cast<unsigned>((n_rows + rpb - 1) / rpb));
  packed_fold_kernel<<<grid, rpb * W, static_cast<size_t>(smem),
                       static_cast<cudaStream_t>(stream)>>>(
      np, ids, r0, out, k, lp, W, n_rows, rpb, n_chunks / n_tenants,
      static_cast<long long>(n_classes) * lp * W);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The fold kernel for K4.  np (n_tenants, n_classes, lp, W) int32 packed
// transition rows; ids (n_chunks, k) int32 class ids in [0, n_classes), in
// n_tenants equal runs; out (n_chunks, lp, W) int32 chunk products.  Returns
// the cudaError_t of the launch (0 on success).
extern "C" int repro_packed_reach_products(const uint32_t* np, const int32_t* ids,
                                           uint32_t* out, int n_chunks, int k, int lp,
                                           int n_classes, int n_tenants, void* stream) {
  return launch_fold(np, ids, nullptr, out, n_chunks, k, lp, lp, n_classes, n_tenants, stream);
}

// The fold kernel for K5.  As for K4, but the fold starts from r0 (n_chunks,
// S, W) int32 and out is (n_chunks, S, W) int32.
extern "C" int repro_sparse_reach_rows(const uint32_t* np, const int32_t* ids,
                                       const uint32_t* r0, uint32_t* out, int n_chunks,
                                       int k, int lp, int S, int n_classes, int n_tenants,
                                       void* stream) {
  return launch_fold(np, ids, r0, out, n_chunks, k, lp, S, n_classes, n_tenants, stream);
}

namespace {

constexpr int WALK_THREADS = 1024;

// np (tenants, n_classes, 32 W, W) packed rows; ids (tenants * n_chunks, k);
// r0 (tenants * n_chunks, rows, W), or null for the identity rows (rows =
// lp); out (tenants * n_chunks, rows, W); n_chunks is a tenant's, and block
// (x, t) serves tenant t.  The group table takes n_classes * cls_stride words of shared memory,
// class x at x * cls_stride.  A warp walks the rows of cpw chunks (cpw *
// rows <= 32) or, with cpw = 1, a 32-row strip of one chunk.  At least one
// block an SM lets ptxas give a thread 64 registers, so that a row's words
// stay in them (K1's finding: left to itself it chose 32 at W = 9, and
// spilled).
template <int W, int G>
__global__ void __launch_bounds__(WALK_THREADS, 1)
packed_walk_kernel(const uint32_t* __restrict__ np, const int32_t* __restrict__ ids,
                   const uint32_t* __restrict__ r0, uint32_t* __restrict__ out, int n_classes,
                   int cls_stride, int n_chunks, int k, int rows, int cpw) {
  extern __shared__ __align__(16) uint32_t sT[];
  constexpr int WS = W | 1;           // entry stride: odd, so distinct v -> distinct banks
  constexpr int V = 1 << G;
  constexpr int GPW = 32 / G;         // groups in a word
  constexpr int GROUP = V * WS;       // words of a group's 2^G entries
  constexpr int CLASS = 32 * W / G * GROUP;   // words of a class, before its padding
  {
    const long long ten = blockIdx.y;
    np += ten * n_classes * 32 * W * W;
    ids += ten * n_chunks * k;
    if (r0 != nullptr) r0 += ten * n_chunks * rows * W;
    out += ten * n_chunks * rows * W;
  }

  // word i of T[x][grp][v] is the OR of word i of rows grp*G + b of Np[x]
  // over the set bits b of v; a class's padding and each entry's word W are 0
  const int t_words = n_classes * cls_stride;
  for (int e = threadIdx.x; e < t_words; e += blockDim.x) {
    const int x = e / cls_stride;
    const int r = e - x * cls_stride;
    const int grp = r / GROUP;
    const int v = (r - grp * GROUP) / WS;
    const int i = r - grp * GROUP - v * WS;
    uint32_t word = 0u;
    if (r < CLASS && i < W) {
      const uint32_t* src = np + (static_cast<long long>(x) * 32 * W + grp * G) * W + i;
#pragma unroll
      for (int b = 0; b < G; ++b)
        if ((v >> b) & 1) word |= __ldg(src + b * W);
    }
    sT[e] = word;
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int strips = cpw == 1 ? (rows + 31) / 32 : 1;
  const int slot = cpw == 1 ? 0 : lane / rows;    // this lane's chunk among the warp's
  const int lane_row = lane - slot * rows;
  // a round of ids: lane l loads step l % rpc of chunk l / rpc (rpc steps a
  // chunk), so that the lanes of one chunk read consecutive ids
  const int rpc = 32 / cpw;
  const int ld_slot = lane / rpc;
  const int ld_step = lane - ld_slot * rpc;
  const int src = (slot < cpw ? slot : 0) * rpc;  // the lane with my chunk's first id of a round
  const long long warps = static_cast<long long>(gridDim.x) * (blockDim.x >> 5);
  // interleaved: the first warps of every block come first, so the units
  // left over after whole rounds spread over all SMs
  const long long gw = static_cast<long long>(threadIdx.x >> 5) * gridDim.x + blockIdx.x;
  const long long units = (static_cast<long long>(n_chunks) + cpw - 1) / cpw * strips;
  for (long long u = gw; u < units; u += warps) {
    const long long c0 = u / strips * cpw;
    const int row = static_cast<int>(u % strips) * 32 + lane_row;
    const long long chunk = c0 + slot;
    const bool live = slot < cpw && chunk < n_chunks && row < rows;
    const long long at = (chunk * rows + row) * W;
    uint32_t cur[W];
    if (r0 == nullptr) {
#pragma unroll
      for (int w = 0; w < W; ++w) cur[w] = live && w == (row >> 5) ? 1u << (row & 31) : 0u;
    } else {
#pragma unroll
      for (int w = 0; w < W; ++w) cur[w] = live ? r0[at + w] : 0u;
    }
    const bool loads = ld_slot < cpw && c0 + ld_slot < n_chunks;
    const int32_t* cid = ids + (loads ? (c0 + ld_slot) * k : 0) + ld_step;
    int idv = loads && ld_step < k ? cid[0] : 0;
    for (int t0 = 0; t0 < k; t0 += rpc) {
      const int nxt = loads && t0 + rpc + ld_step < k ? cid[t0 + rpc] : 0;
      const int steps = k - t0 < rpc ? k - t0 : rpc;
      for (int s = 0; s < steps; ++s) {
        const uint32_t* tb = sT + __shfl_sync(0xffffffffu, idv, src + s) * cls_stride;
        uint32_t nw[W];
#pragma unroll
        for (int i = 0; i < W; ++i) nw[i] = 0u;
        // word w of the row is consumed from cur[0], the rest shifted down,
        // so that the loop over words need not be unrolled (it is at W <= 4,
        // where a step's lookups then issue together)
#pragma unroll(W <= 4 ? W : 1)
        for (int w = 0; w < W; ++w) {
          const uint32_t word = cur[0];
#pragma unroll
          for (int i = 0; i + 1 < W; ++i) cur[i] = cur[i + 1];
          const uint32_t* gb = tb + w * (GPW * GROUP);
#pragma unroll
          for (int b = 0; b < GPW; ++b) {
            const uint32_t* e = gb + (b * V + ((word >> (b * G)) & (V - 1))) * WS;
#pragma unroll
            for (int i = 0; i < W; ++i) nw[i] |= e[i];
          }
        }
#pragma unroll
        for (int i = 0; i < W; ++i) cur[i] = nw[i];
      }
      idv = nxt;
    }
    if (live) {
#pragma unroll
      for (int w = 0; w < W; ++w) out[at + w] = cur[w];
    }
  }
}

typedef void (*WalkKernel)(const uint32_t*, const int32_t*, const uint32_t*, uint32_t*, int, int,
                           int, int, int, int);

template <int W>
WalkKernel walk_kernel_g(int g) {
  return g == 4 ? &packed_walk_kernel<W, 4> : g == 2 ? &packed_walk_kernel<W, 2> : nullptr;
}

WalkKernel walk_kernel(int W, int g) {
  switch (W) {
    case 1: return walk_kernel_g<1>(g);
    case 2: return walk_kernel_g<2>(g);
    case 3: return walk_kernel_g<3>(g);
    case 4: return walk_kernel_g<4>(g);
    case 5: return walk_kernel_g<5>(g);
    case 6: return walk_kernel_g<6>(g);
    case 7: return walk_kernel_g<7>(g);
    case 8: return walk_kernel_g<8>(g);
    case 9: return walk_kernel_g<9>(g);
    case 10: return walk_kernel_g<10>(g);
    case 11: return walk_kernel_g<11>(g);
    case 12: return walk_kernel_g<12>(g);
    case 13: return walk_kernel_g<13>(g);
    case 14: return walk_kernel_g<14>(g);
    case 15: return walk_kernel_g<15>(g);
    case 16: return walk_kernel_g<16>(g);
    default: return nullptr;
  }
}

}  // namespace

// The walk kernel, K4's (r0 null: the identity rows, rows = lp) and K5's.
// np (n_tenants, n_classes, lp, W) int32 packed rows; ids (n_chunks, k)
// int32 class ids in [0, n_classes), in n_tenants equal runs (at most
// 65535 tenants); r0 and out (n_chunks, rows, W) int32.  g in {2, 4},
// lp % 32 == 0, lp <= 512, rows <= lp; cpw chunks a warp, 1 or with
// cpw * rows <= 32; cls_stride >= (lp/g) * 2^g * (W|1) words a class, and
// n_classes * cls_stride * 4 bytes within one block's shared memory.  The
// launcher (kernels/packed_reach.py) plans cpw and cls_stride.  Returns the
// cudaError_t of the launch (0 on success).
extern "C" int repro_packed_walk(const uint32_t* np, const int32_t* ids, const uint32_t* r0,
                                 uint32_t* out, int n_classes, int n_chunks, int k, int lp,
                                 int rows, int g, int cpw, int cls_stride, int n_tenants,
                                 void* stream) {
  if (n_chunks <= 0 || rows <= 0) return 0;
  const WalkKernel fn = lp > 0 && lp % 32 == 0 ? walk_kernel(lp / 32, g) : nullptr;
  if (fn == nullptr || n_classes < 1 || k < 0 || rows > lp || (r0 == nullptr && rows != lp) ||
      cpw < 1 || (cpw > 1 && cpw * rows > 32) ||
      cls_stride < (lp / g) * (1 << g) * ((lp / 32) | 1) || n_tenants < 1 ||
      n_tenants > 65535 || n_chunks % n_tenants != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int cpt = n_chunks / n_tenants;         // chunks a tenant
  const size_t smem = static_cast<size_t>(n_classes) * cls_stride * 4;
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
  const long long strips = cpw == 1 ? (rows + 31) / 32 : 1;
  const long long tenant_units = (static_cast<long long>(cpt) + cpw - 1) / cpw * strips;
  const long long units = tenant_units * n_tenants;
  long long wpb = (units + sms - 1) / sms;
  wpb = wpb > tenant_units ? tenant_units : wpb;   // no more warps than a tenant has units
  wpb = wpb < 1 ? 1 : wpb > WALK_THREADS / 32 ? WALK_THREADS / 32 : wpb;
  const int threads = static_cast<int>(wpb) * 32;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, threads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  long long blocks = (tenant_units + wpb - 1) / wpb;
  long long cap = static_cast<long long>(sms) * per_sm / n_tenants;
  cap = cap < 1 ? 1 : cap;
  if (blocks > cap) blocks = cap;
  const dim3 grid(static_cast<unsigned>(blocks), static_cast<unsigned>(n_tenants));
  fn<<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      np, ids, r0, out, n_classes, cls_stride, cpt, k, rows, cpw);
  return static_cast<int>(cudaGetLastError());
}
