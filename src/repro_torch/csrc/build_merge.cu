// K2: build&merge (paper Fig. 14), the fused forward/backward frontier scan of
// one chunk, emitting the clean SLPF columns already packed into words.
//
// Replaces: src/repro/kernels/build.py, build_merge_chunk (_build_fwd_kernel and
// _merge_bwd_kernel), two sequential pallas_calls per chunk that share an
// aliased (k, lp) f32 M buffer: the forward scan writes M[t] = clamp(N[x_t] f),
// the backward scan with N^T ANDs beta_{t+1} into M[t] in place.
//
// Bound on this card: per chunk 2k dependent steps, each a mat-vec of lp^2
// over {0,1}, against C*k ids in and C*k*W words out.  A step is tiny, so the
// latency of one step bounds a chunk, and the chunks side by side fill the card.
//
// Two kernels; the launcher's plan (kernels/build.py) picks one by the size of
// the tables:
//
// build_merge_walk_kernel (the plan's first choice), a group-table frontier
// walk: the design of K1's group kernel and K4 / K5's walk, applied to one
// vector in each direction.  For every class x, every g-bit group of states
// and every value v of the group:
//   forward  T_f[x][grp][v] = OR of the columns grp*g + b of N[x], b in v
//   backward T_b[x][grp][v] = OR of the rows    grp*g + b of N[x], b in v
// each W words, at a stride of W | 1 words (odd, so that the 2^g entries of a
// group lie in distinct banks).  Each block builds the tables into its shared
// memory straight from f32 N, so nothing is packed per call: a warp takes one
// 32 x 32 tile of N[x], whose 32 coalesced rows give the packed columns (each
// lane's own bits) and, by __ballot_sync, the packed rows; lanes combine them
// into entries with __shfl_sync.  A forward step is
//   f <- OR over the groups grp of T_f[x_t][grp][nibble(f, grp)]
// and output row t is f; a backward step ANDs beta_{t+1} into output row t,
// then beta <- OR over grp of T_b[x_t][grp][nibble(beta, grp)].  Where both
// tables fit in shared memory they stay for the whole launch; else T_f is
// built, every forward pass walked, and T_b rebuilt in its place between the
// passes (one barrier each side).
//   L = 8 lanes walk one chunk (a plan parameter; 2, 4 and 8 were measured,
// and 8 was fastest on both parse shapes): lane `sub` looks up groups sub,
// sub + L, ... of every word, so a step is (lp/g)/L lookups a lane, then the
// words are ORed over the L lanes by __shfl_xor_sync, with no block barrier.
// A warp walks 32/L = 4 chunks side by side (TRAFFIC: 2 lookups of 2 words
// a lane a step; e125: 9 lookups of 9 words).
// Class ids and, for the backward pass, the forward rows come in by 4-byte
// cp.async one round of `rs` steps ahead (up to 128: each round's staging
// costs microseconds, so the plan takes the longest that fits) into a
// per-warp ring in shared memory; output rows are
// written into the ring at each step and go out to device memory at the end
// of each round, one coalesced run per chunk.  So no step waits on a load from
// device memory, and none on a barrier.  A block is 1024 threads: all of them
// build the tables, the first `walk_warps` warps walk.  PAD steps (N = the
// identity) are walked like any other and write their column.
//
// build_merge_rows_kernel (tables that no group width fits): the port's first
// design.  One block per chunk, one thread per state row (lp <= 1024), the
// frontier in shared memory as W words, one __syncthreads a step: thread i
// computes (OR_w Nr[x_t][i][w] & v[w]) != 0 from the row-packed table, the
// warp's __ballot_sync is word i/32 of the new frontier.  The backward pass
// does the same over the column-packed table and ANDs into the words the
// forward pass wrote.
//
// Both write the packed (n_chunks, k, W) words of the plain version.
//
// The live window (kernels/window.py; the fleet's buckets padded past their
// live states): where every table is block-diagonal, N[x] = diag(A_x, D_x)
// with A_x over the lw live states and D_x in {0, I}, the live states'
// frontiers never meet the padded ones.  The launcher then runs the walk
// kernel as it is on the live block (the tables of A_x, the entries' first
// lw states; e125's bucket at lp = 512: lw = 288, the solo e125 walk) into
// a (n_chunks, k, lw/32) scratch, and build_merge_pad_kernel writes the
// (n_chunks, k, lp/32) output: the walk's words, then the padded words from
// the algebra.  The padded forward frontier is entry_f's while every step
// so far has D = I and 0 from the first other step, the backward one
// likewise from entry_b, so every row's padded words are entry_f & entry_b
// there when every step of the chunk has D = I, else 0.  One warp a chunk
// finds that flag from the chunk's ids, 32 at a time, and a per-class bit
// (ident), packs the entries' padded words by __ballot_sync, and writes the
// chunk's k rows as one coalesced run.  (A walk that carried the output's
// stride itself spilled in every width.)  The row kernel has no window: it
// walks every state.
//
// The tenant axis (the fleet's bucket dispatch, core/fleet.py), as in K1
// (csrc/reach.cu): T automata of one bucket shape, N stacked (T, A+1, lp,
// lp), their chunks (and entries, and outputs) in T equal runs of cpt.  The
// walk kernel's grid is (blocks a tenant, T): a block builds its own
// tenant's tables and walks that tenant's chunks, so a warp's 32/L chunks
// are always one tenant's.  The row kernel reads chunk c's rows from tenant
// c / cpt's packed tables.  T = 1 is a plain launch.
//
// unpack_columns_kernel replaces no TPU kernel: the reference unpacks the
// packed columns on the host (src/repro/core/engine.py, _assemble), and the
// port did too until the host's pass over a 1 MiB text (a fresh
// (n+1, 32 W) byte array, then a bool copy of its first ell columns) took
// four fifths of a parse.  It writes the forest the SLPF keeps, (n+1, ell)
// bool, on the card, so that only those bytes come back, in one copy a text.
// One launch covers a bucket group: batch row b's C0 (W words) and its
// (c * k, W) packed rows, of which the first n_b are the text's.  Forest row
// 0 is C0 and row r is packed row r - 1; byte j of a row is bit j % 32 of
// word j / 32 (little-endian).  A block stages 128 rows' words in shared
// memory by coalesced loads (every word of the tile read once, then shared
// by every thread that writes a byte of it) and writes the tile's 128 * ell
// bytes, contiguous in the output, as coalesced 16-byte stores: a thread
// builds its 16 bytes from at most a few words, carried in a register as j
// runs along a row.  Each batch row's bytes start at a multiple of 16, so
// every store is aligned; the last one of a batch row may run into that
// padding.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr long long MAX_SMEM = 232448;

// ============================================================ row kernel

__global__ void build_merge_rows_kernel(const uint32_t* __restrict__ nr,
                                        const uint32_t* __restrict__ nc,
                                        const int32_t* __restrict__ ids,
                                        const float* __restrict__ entry_f,
                                        const float* __restrict__ entry_b,
                                        uint32_t* __restrict__ out, int k, int lp, int W,
                                        int cpt, long long table_words) {
  extern __shared__ uint32_t sv[];   // [2][W] packed frontier
  const long long chunk = blockIdx.x;
  const int i = threadIdx.x;
  const int lane = i & 31;
  const int warp = i >> 5;
  const long long NW = static_cast<long long>(lp) * W;
  nr += chunk / cpt * table_words;   // this chunk's tenant's tables
  nc += chunk / cpt * table_words;
  const int32_t* cid = ids + chunk * k;
  uint32_t* o = out + chunk * k * W;

  uint32_t word = __ballot_sync(FULL, entry_f[chunk * lp + i] != 0.f);
  if (lane == 0) sv[warp] = word;
  __syncthreads();

  int cur = 0;
  for (int t = 0; t < k; ++t) {                     // forward: fwd[t] = N[x_t] fwd
    const uint32_t* row = nr + cid[t] * NW + static_cast<long long>(i) * W;
    const uint32_t* v = sv + cur * W;
    uint32_t acc = 0;
    for (int w = 0; w < W; ++w) acc |= __ldg(row + w) & v[w];
    word = __ballot_sync(FULL, acc != 0);
    if (lane == 0) {
      sv[(cur ^ 1) * W + warp] = word;
      o[static_cast<long long>(t) * W + warp] = word;
    }
    cur ^= 1;
    __syncthreads();
  }

  word = __ballot_sync(FULL, entry_b[chunk * lp + i] != 0.f);
  if (lane == 0) sv[cur * W + warp] = word;         // beta_k = entry_b
  __syncthreads();

  for (int t = k - 1; t >= 0; --t) {                // backward + merge
    const uint32_t* b = sv + cur * W;               // beta_{t+1}
    if (lane == 0) o[static_cast<long long>(t) * W + warp] &= b[warp];
    const uint32_t* col = nc + cid[t] * NW + static_cast<long long>(i) * W;
    uint32_t acc = 0;
    for (int w = 0; w < W; ++w) acc |= __ldg(col + w) & b[w];
    word = __ballot_sync(FULL, acc != 0);
    if (lane == 0) sv[(cur ^ 1) * W + warp] = word;
    cur ^= 1;
    __syncthreads();
  }
}

// =========================================================== walk kernel

constexpr int WALK_THREADS = 1024;

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most the newest committed group is in flight
__device__ __forceinline__ void cp_async_wait_prev() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// The forward table (tf) and / or the backward table (tb) of every class, from
// f32 N (n_classes, 32 W, 32 W); a null table is not built.  Entry (x, grp, v)
// word i lies at x * cls_stride + (grp * 2^G + v) * (W | 1) + i; the padding
// words are never read.  One warp task is one 32 x 32 tile (x, a, b) of N[x],
// rows 32a.., columns 32b..: lane l reads column 32b + l of its 32 rows.
template <int W, int G>
__device__ void build_tables(const float* __restrict__ N, uint32_t* tf, uint32_t* tb,
                             int n_classes, int cls_stride) {
  constexpr int WS = W | 1, V = 1 << G, GPW = 32 / G, LP = 32 * W;
  const int lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5;
  const int tasks = n_classes * W * W;
  for (int task = threadIdx.x >> 5; task < tasks; task += warps) {
    const int x = task / (W * W);
    const int a = (task / W) % W;
    const int b = task % W;
    const float* src = N + (static_cast<long long>(x) * LP + 32 * a) * LP + 32 * b + lane;
    uint32_t col = 0u;   // word a of packed column 32b + lane: bit r = N[x][32a + r][32b + lane]
    uint32_t row = 0u;   // word b of packed row 32a + lane: bit c = N[x][32a + lane][32b + c]
#pragma unroll 1
    for (int r0 = 0; r0 < 32; r0 += 8) {
      float v[8];
#pragma unroll
      for (int r = 0; r < 8; ++r) v[r] = __ldg(src + static_cast<long long>(r0 + r) * LP);
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const bool nz = v[r] != 0.f;
        col |= static_cast<uint32_t>(nz) << (r0 + r);
        const uint32_t rw = __ballot_sync(FULL, nz);
        if (lane == r0 + r) row = rw;
      }
    }
    // entry (gi, v) of the GPW groups of this tile: the OR over the set bits
    // of v of the g packed columns (forward) or rows (backward) of group gi
#pragma unroll
    for (int e0 = 0; e0 < GPW * V; e0 += 32) {
      const int e = e0 + lane;
      const int gi = e >> G, v = e & (V - 1);
      uint32_t ef = 0u, eb = 0u;
#pragma unroll
      for (int bit = 0; bit < G; ++bit) {
        const uint32_t cf = __shfl_sync(FULL, col, gi * G + bit);
        const uint32_t cb = __shfl_sync(FULL, row, gi * G + bit);
        if ((v >> bit) & 1) {
          ef |= cf;
          eb |= cb;
        }
      }
      if (tf != nullptr) tf[x * cls_stride + ((b * GPW + gi) * V + v) * WS + a] = ef;
      if (tb != nullptr) tb[x * cls_stride + ((a * GPW + gi) * V + v) * WS + b] = eb;
    }
  }
}

// One pass (forward FWD, else backward) over the chunks c0 .. c0 + 32/L - 1
// of one unit, by one warp.  s_ids (2, cpw, rs + 1) and s_rows (2, cpw,
// rs * W + 1) are the warp's ring; ids (n_chunks, k), entry (n_chunks, 32 W),
// out (n_chunks, k, W).
template <int W, int G, int L, bool FWD>
__device__ __forceinline__ void walk_pass(const uint32_t* __restrict__ table,
                                          const int32_t* __restrict__ ids,
                                          const float* __restrict__ entry,
                                          uint32_t* __restrict__ out, int32_t* s_ids,
                                          uint32_t* s_rows, long long c0, int n_chunks, int k,
                                          int rs, int cls_stride) {
  constexpr int WS = W | 1, V = 1 << G, GPW = 32 / G, GROUP = V * WS, GPL = GPW / L;
  constexpr int CPW = 32 / L;
  const int lane = threadIdx.x & 31;
  const int slot = lane / L, sub = lane % L;
  const long long chunk = c0 + slot;
  const int ids_stride = rs + 1, rows_stride = rs * W + 1;

  uint32_t f[W];
#pragma unroll
  for (int w = 0; w < W; ++w) {
    uint32_t word = 0u;
    if (chunk < n_chunks) {
      const float* e = entry + chunk * (32 * W) + 32 * w;
      for (int b = 0; b < 32; ++b) word |= static_cast<uint32_t>(e[b] != 0.f) << b;
    }
    f[w] = word;
  }

  // round r's ids (and, backward, its forward rows) into ring buffer buf
  auto stage = [&](int r, int buf) {
    const int t0 = r * rs;
    const int n = k - t0 < rs ? k - t0 : rs;
    int32_t* si = s_ids + buf * CPW * ids_stride;
    uint32_t* sr = s_rows + buf * CPW * rows_stride;
    for (int sl = 0; sl < CPW; ++sl) {
      const long long ch = c0 + sl;
      const bool in = ch < n_chunks;
      for (int s = lane; s < rs; s += 32) {
        if (in && s < n)
          cp_async4(si + sl * ids_stride + s, ids + ch * k + t0 + s);
        else
          si[sl * ids_stride + s] = 0;          // a step no lane reads, or a chunk past the end
      }
      if (!FWD && in) {
        const uint32_t* src = out + (ch * k + t0) * W;
        for (int o = lane; o < n * W; o += 32) cp_async4(sr + sl * rows_stride + o, src + o);
      }
    }
    cp_async_commit();
  };

  const int n_rounds = (k + rs - 1) / rs;
  stage(FWD ? 0 : n_rounds - 1, 0);
  for (int it = 0; it < n_rounds; ++it) {
    const int r = FWD ? it : n_rounds - 1 - it;
    const int buf = it & 1;
    if (it + 1 < n_rounds)
      stage(FWD ? r + 1 : r - 1, buf ^ 1);
    else
      cp_async_commit();                        // an empty group: wait_group 1 below still waits for round r
    cp_async_wait_prev();
    __syncwarp();
    const int t0 = r * rs;
    const int n = k - t0 < rs ? k - t0 : rs;
    const int32_t* si = s_ids + buf * CPW * ids_stride + slot * ids_stride;
    uint32_t* rows = s_rows + buf * CPW * rows_stride + slot * rows_stride;
    int x = si[FWD ? 0 : n - 1];
    for (int q = 0; q < n; ++q) {
      const int s = FWD ? q : n - 1 - q;
      const int xn = q + 1 < n ? si[FWD ? s + 1 : s - 1] : 0;
      uint32_t* row = rows + s * W;
      if (!FWD) {
#pragma unroll
        for (int i = 0; i < W; ++i)
          if (i % L == sub) row[i] &= f[i];      // output t = fwd[t] & beta_{t+1}
      }
      const uint32_t* tx = table + x * cls_stride + sub * GROUP;
      uint32_t acc[W];
#pragma unroll
      for (int i = 0; i < W; ++i) acc[i] = 0u;
      // word w of the frontier is consumed from f[0], the rest shifted down,
      // so that the loop over words need not be unrolled; it is where a
      // step's lookups are few enough to issue together (at most 24: at 30
      // and 32, W = 15 and 16 at g = 2, the unrolled loop spilled)
#pragma unroll(W * GPL <= 24 ? W : 1)
      for (int w = 0; w < W; ++w) {
        const uint32_t word = f[0] >> (sub * G);
#pragma unroll
        for (int i = 0; i + 1 < W; ++i) f[i] = f[i + 1];
        const uint32_t* gb = tx + w * (GPW * GROUP);
#pragma unroll
        for (int j = 0; j < GPL; ++j) {
          const uint32_t* e = gb + j * (L * GROUP) + ((word >> (j * L * G)) & (V - 1)) * WS;
#pragma unroll
          for (int i = 0; i < W; ++i) acc[i] |= e[i];
        }
      }
      // the OR over the chunk's L lanes (a butterfly of shuffles: one
      // redux.sync a word measured 3.5x slower on the H100)
#pragma unroll
      for (int m = 1; m < L; m <<= 1)
#pragma unroll
        for (int i = 0; i < W; ++i) acc[i] |= __shfl_xor_sync(FULL, acc[i], m);
#pragma unroll
      for (int i = 0; i < W; ++i) f[i] = acc[i];
      if (FWD) {
#pragma unroll
        for (int i = 0; i < W; ++i)
          if (i % L == sub) row[i] = f[i];
      }
      x = xn;
    }
    __syncwarp();
    // the round's rows of each chunk out to device memory, one coalesced run
    for (int sl = 0; sl < CPW; ++sl) {
      const long long ch = c0 + sl;
      if (ch >= n_chunks) break;
      const uint32_t* sr = s_rows + buf * CPW * rows_stride + sl * rows_stride;
      uint32_t* dst = out + (ch * k + t0) * W;
      for (int o = lane; o < n * W; o += 32) dst[o] = sr[o];
    }
    __syncwarp();
  }
  cp_async_wait_all();
  __syncwarp();
}

// N (tenants, n_classes, 32 W, 32 W) f32; ids (tenants * n_chunks, k);
// entries (tenants * n_chunks, 32 W) f32; out (tenants * n_chunks, k, W);
// n_chunks is a tenant's, and block (x, t) serves tenant t.  Shared memory:
// the table(s), then walk_warps rings of 2 * (32/L) * ((rs + 1) + (rs * W +
// 1)) words.  At least one block an SM at 1024 threads gives a thread 64
// registers (K1's and K4's finding: a frontier's words then stay in them).
template <int W, int G, int L>
__global__ void __launch_bounds__(WALK_THREADS, 1)
build_merge_walk_kernel(const float* __restrict__ N, const int32_t* __restrict__ ids,
                        const float* __restrict__ entry_f, const float* __restrict__ entry_b,
                        uint32_t* __restrict__ out, int n_classes, int cls_stride, int n_chunks,
                        int k, int rs, int both, int walk_warps) {
  extern __shared__ __align__(16) uint32_t smem[];
  constexpr int CPW = 32 / L;
  {
    const long long ten = blockIdx.y, LP = 32 * W;
    N += ten * n_classes * LP * LP;
    ids += ten * n_chunks * k;
    entry_f += ten * n_chunks * LP;
    entry_b += ten * n_chunks * LP;
    out += ten * n_chunks * k * W;
  }
  const int table_words = n_classes * cls_stride;
  uint32_t* tf = smem;
  uint32_t* tb = both ? smem + table_words : smem;
  const int ring_words = 2 * CPW * ((rs + 1) + (rs * W + 1));
  const int warp = threadIdx.x >> 5;
  int32_t* s_ids = reinterpret_cast<int32_t*>(smem + (both ? 2 : 1) * table_words +
                                              warp * ring_words);
  uint32_t* s_rows = reinterpret_cast<uint32_t*>(s_ids) + 2 * CPW * (rs + 1);

  const bool walks = warp < walk_warps;
  const long long total = static_cast<long long>(walk_warps) * gridDim.x;
  // interleaved: the first warps of every block come first
  const long long gw = static_cast<long long>(warp) * gridDim.x + blockIdx.x;
  const long long units = (static_cast<long long>(n_chunks) + CPW - 1) / CPW;

  // both: one pass builds both tables and walks each unit forward, then
  // backward; else pass 0 builds T_f and walks forward, pass 1 T_b, backward
  for (int pass = 0; pass < (both ? 1 : 2); ++pass) {
    if (pass == 1) __syncthreads();             // every forward walk is done with T_f
    build_tables<W, G>(N, pass == 0 ? tf : nullptr, both || pass == 1 ? tb : nullptr, n_classes,
                       cls_stride);
    __syncthreads();
    if (!walks) continue;
    for (long long u = gw; u < units; u += total) {
      if (pass == 0)
        walk_pass<W, G, L, true>(tf, ids, entry_f, out, s_ids, s_rows, u * CPW, n_chunks, k, rs,
                                 cls_stride);
      if (both || pass == 1) {
        __threadfence_block();                  // the forward rows, read back below
        walk_pass<W, G, L, false>(tb, ids, entry_b, out, s_ids, s_rows, u * CPW, n_chunks, k,
                                  rs, cls_stride);
      }
    }
  }
}

typedef void (*WalkKernel)(const float*, const int32_t*, const float*, const float*, uint32_t*,
                           int, int, int, int, int, int, int);

// Lanes a chunk (kernels/build.py's LANES): one count, so that one
// instantiation a width keeps the build short.
constexpr int WALK_LANES = 8;

template <int W>
WalkKernel walk_kernel_g(int g) {
  return g == 4 ? &build_merge_walk_kernel<W, 4, WALK_LANES>
       : g == 2 ? &build_merge_walk_kernel<W, 2, WALK_LANES>
                : nullptr;
}

WalkKernel walk_kernel(int W, int g, int lanes) {
  if (lanes != WALK_LANES) return nullptr;
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

// The window's output: out (n_chunks, k, lp/32) from the walk's live words
// live (n_chunks, k, lw/32) and the padded words of entry_f & entry_b
// (n_chunks, lp) where every step of the chunk has D = I (ident, the
// chunk's tenant's (n_classes) flags), else 0.  One warp a chunk.
__global__ void build_merge_pad_kernel(const int32_t* __restrict__ ids,
                                       const int32_t* __restrict__ ident,
                                       const float* __restrict__ entry_f,
                                       const float* __restrict__ entry_b,
                                       const uint32_t* __restrict__ live,
                                       uint32_t* __restrict__ out, int n_chunks, int k, int lp,
                                       int lw, int n_classes, int cpt) {
  const int lane = threadIdx.x & 31;
  const int wp = lp / 32, wl = lw / 32, pw = wp - wl;
  const long long warps = static_cast<long long>(gridDim.x) * (blockDim.x >> 5);
  for (long long chunk = static_cast<long long>(blockIdx.x) * (blockDim.x >> 5) +
                         (threadIdx.x >> 5);
       chunk < n_chunks; chunk += warps) {
    const int32_t* cid = ids + chunk * k;
    const int32_t* flags = ident + chunk / cpt * n_classes;
    bool flag = true;
    for (int t0 = 0; t0 < k && flag; t0 += 32) {
      const int t = t0 + lane;
      flag = __all_sync(FULL, t >= k || __ldg(flags + __ldg(cid + t)) != 0);
    }
    uint32_t mine = 0u;          // lane p < pw: padded word p of entry_f & entry_b
    for (int p = 0; p < pw; ++p) {
      const long long at = chunk * lp + lw + 32 * p + lane;
      const uint32_t wf = __ballot_sync(FULL, __ldg(entry_f + at) != 0.f);
      const uint32_t wb = __ballot_sync(FULL, __ldg(entry_b + at) != 0.f);
      if (lane == p) mine = flag ? wf & wb : 0u;
    }
    const uint32_t* src = live + chunk * k * wl;
    uint32_t* dst = out + chunk * k * wp;
    const int n = k * wp;
    for (int e0 = 0; e0 < n; e0 += 32) {
      const int e = e0 + lane;
      const int t = e / wp, w = e % wp;
      const uint32_t pad = __shfl_sync(FULL, mine, w < wl ? 0 : w - wl);
      if (e < n) dst[e] = w < wl ? __ldg(src + static_cast<long long>(t) * wl + w) : pad;
    }
  }
}

// ========================================================= unpack kernel

constexpr int UNPACK_ROWS = 128;     // forest rows a block stages at a time
constexpr int UNPACK_THREADS = 256;

// Batch row b = blockIdx.y: meta[2b] forest rows (n_b + 1) from C0 col0[b]
// (W words) and the packed rows cols[b] (rows_cap = c * k rows of W words),
// as ell bytes a row at out + meta[2b + 1] (a multiple of 16).
__global__ void __launch_bounds__(UNPACK_THREADS)
unpack_columns_kernel(const uint32_t* __restrict__ col0, const uint32_t* __restrict__ cols,
                      const long long* __restrict__ meta, uint8_t* __restrict__ out, int W,
                      int ell, long long rows_cap) {
  extern __shared__ uint32_t sw[];                  // [UNPACK_ROWS][W]
  const long long b = blockIdx.y;
  const long long rows = __ldg(meta + 2 * b);
  uint8_t* const base = out + __ldg(meta + 2 * b + 1);
  for (long long r0 = static_cast<long long>(blockIdx.x) * UNPACK_ROWS; r0 < rows;
       r0 += static_cast<long long>(gridDim.x) * UNPACK_ROWS) {
    const int nr = rows - r0 < UNPACK_ROWS ? static_cast<int>(rows - r0) : UNPACK_ROWS;
    // word e of the tile is word e of packed row r0 - 1 onwards (row 0: C0)
    const long long from = (b * rows_cap + r0 - 1) * W;
    __syncthreads();                                // the previous tile is written
    for (int e = threadIdx.x; e < nr * W; e += UNPACK_THREADS)
      sw[e] = r0 == 0 && e < W ? __ldg(col0 + b * W + e) : __ldg(cols + from + e);
    __syncthreads();
    uint8_t* dst = base + r0 * ell;
    const int n_bytes = nr * ell;
    for (int q = 16 * threadIdx.x; q < n_bytes; q += 16 * UNPACK_THREADS) {
      int r = q / ell, j = q - r * ell;
      uint32_t word = sw[r * W + (j >> 5)];
      uint32_t v[4] = {0u, 0u, 0u, 0u};
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        if (r < nr) v[i >> 2] |= ((word >> (j & 31)) & 1u) << (8 * (i & 3));
        if (++j == ell) {
          j = 0;
          ++r;
        }
        if ((j & 31) == 0 && r < nr) word = sw[r * W + (j >> 5)];
      }
      *reinterpret_cast<uint4*>(dst + q) = make_uint4(v[0], v[1], v[2], v[3]);
    }
  }
}

}  // namespace

// The row kernel.  nr, nc (n_tenants, n_classes, lp, W) int32: N packed
// along its columns (row-packed) and along its rows (column-packed); ids
// (n_chunks, k) int32 in [0, n_classes), in n_tenants equal runs; entry_f,
// entry_b (n_chunks, lp) f32 {0,1}; out (n_chunks, k, W) int32.  lp % 32 ==
// 0 and lp <= 1024.  Returns the cudaError_t of the launch (0 on success).
extern "C" int repro_build_merge_packed(const uint32_t* nr, const uint32_t* nc,
                                        const int32_t* ids, const float* entry_f,
                                        const float* entry_b, uint32_t* out,
                                        int n_chunks, int k, int lp, int n_classes,
                                        int n_tenants, void* stream) {
  if (n_chunks <= 0) return 0;
  if (lp <= 0 || lp % 32 != 0 || lp > 1024 || n_tenants < 1 || n_chunks % n_tenants != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int W = lp / 32;
  build_merge_rows_kernel<<<static_cast<unsigned>(n_chunks), lp, 2 * W * sizeof(uint32_t),
                            static_cast<cudaStream_t>(stream)>>>(
      nr, nc, ids, entry_f, entry_b, out, k, lp, W, n_chunks / n_tenants,
      static_cast<long long>(n_classes) * lp * W);
  return static_cast<int>(cudaGetLastError());
}

// The walk kernel.  N (n_tenants, n_classes, lp, lp) f32 {0,1}; ids
// (n_chunks, k) int32 in [0, n_classes), in n_tenants equal runs (at most
// 65535 tenants); entry_f, entry_b (n_chunks, lp) f32; out (n_chunks, k, W)
// int32.  g in {2, 4}, lanes = WALK_LANES, lp % 32 == 0, lp <= 512;
// rs (steps a round) in 1 .. 128; both: 1 if both tables stay
// in shared memory, 0 to rebuild the backward table between the passes;
// cls_stride >= (lp/g) * 2^g * (W|1) words a class.  The launcher
// (kernels/build.py) plans them.  Returns the cudaError_t of the launch (0 on
// success).
extern "C" int repro_build_merge_walk(const float* N, const int32_t* ids, const float* entry_f,
                                      const float* entry_b, uint32_t* out, int n_classes,
                                      int n_chunks, int k, int lp, int g, int lanes, int rs,
                                      int both, int cls_stride, int n_tenants, void* stream) {
  if (n_chunks <= 0 || k <= 0) return 0;
  const int W = lp / 32;
  const WalkKernel fn = lp > 0 && lp % 32 == 0 ? walk_kernel(W, g, lanes) : nullptr;
  if (fn == nullptr || n_classes < 1 || lanes > 32 / g || rs < 1 || rs > 128 ||
      cls_stride < (lp / g) * (1 << g) * (W | 1) || n_tenants < 1 || n_tenants > 65535 ||
      n_chunks % n_tenants != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int cpt = n_chunks / n_tenants;         // chunks a tenant
  const int cpw = 32 / lanes;
  const long long table = (both ? 2LL : 1LL) * n_classes * cls_stride * 4;
  const long long ring = 4LL * 2 * cpw * ((rs + 1) + (rs * W + 1));
  if (table + ring > MAX_SMEM) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err;
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return static_cast<int>(err);
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return static_cast<int>(err);
  // about as many walking warps an SM as there are units (of every tenant)
  // for it, as shared memory allows; one block an SM, the SMs shared out over
  // the tenants (a unit is a warp's chunks, all of one tenant)
  const long long tenant_units = (static_cast<long long>(cpt) + cpw - 1) / cpw;
  const long long units = (static_cast<long long>(n_chunks) + cpw - 1) / cpw;
  long long ww = (units + sms - 1) / sms;
  const long long fit = (MAX_SMEM - table) / ring;
  ww = ww > tenant_units ? tenant_units : ww;      // no more warps than a tenant has units
  ww = ww < 1 ? 1 : ww > WALK_THREADS / 32 ? WALK_THREADS / 32 : ww;
  ww = ww > fit ? fit : ww;
  long long blocks = (tenant_units + ww - 1) / ww;
  long long cap = sms / n_tenants;
  cap = cap < 1 ? 1 : cap;
  if (blocks > cap) blocks = cap;
  const size_t smem = static_cast<size_t>(table + ww * ring);
  err = cudaFuncSetAttribute(reinterpret_cast<const void*>(fn),
                             cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(blocks), static_cast<unsigned>(n_tenants));
  fn<<<grid, WALK_THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      N, ids, entry_f, entry_b, out, n_classes, cls_stride, cpt, k, rs, both,
      static_cast<int>(ww));
  return static_cast<int>(cudaGetLastError());
}

// The window's output (see build_merge_pad_kernel): ids (n_chunks, k) in
// n_tenants equal runs; ident (n_tenants, n_classes) int32 flags; entry_f,
// entry_b (n_chunks, lp) f32; live (n_chunks, k, lw/32) the walk's words on
// the lw live states; out (n_chunks, k, lp/32).  lp and lw multiples of 32,
// lw < lp.  Returns the cudaError_t of the launch (0 on success).
extern "C" int repro_build_merge_pad(const int32_t* ids, const int32_t* ident,
                                     const float* entry_f, const float* entry_b,
                                     const uint32_t* live, uint32_t* out, int n_chunks, int k,
                                     int lp, int lw, int n_classes, int n_tenants,
                                     void* stream) {
  if (n_chunks <= 0 || k <= 0) return 0;
  if (lp % 32 != 0 || lw % 32 != 0 || lw <= 0 || lw >= lp || n_classes < 1 ||
      n_tenants < 1 || n_chunks % n_tenants != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  constexpr int THREADS = 256;                  // 8 warps, one chunk each
  const long long blocks = (static_cast<long long>(n_chunks) + 7) / 8;
  build_merge_pad_kernel<<<static_cast<unsigned>(blocks < 65535 ? blocks : 65535), THREADS, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      ids, ident, entry_f, entry_b, live, out, n_chunks, k, lp, lw, n_classes,
      n_chunks / n_tenants);
  return static_cast<int>(cudaGetLastError());
}

// The forests of a bucket group (see unpack_columns_kernel): col0 (>= n_rows,
// W) and cols (>= n_rows, rows_cap, W) int32 words; meta (n_rows, 2) int64:
// forest rows (at most rows_cap + 1) and byte offset (a multiple of 16) of
// each batch row; out holds each batch row's rows * ell bytes rounded up to
// 16.  max_rows is the largest forest; 1 <= ell <= 32 W, n_rows <= 65535.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int repro_unpack_columns(const uint32_t* col0, const uint32_t* cols,
                                    const long long* meta, uint8_t* out, int n_rows, int W,
                                    int ell, long long rows_cap, long long max_rows,
                                    void* stream) {
  if (n_rows <= 0 || max_rows <= 0) return 0;
  if (W < 1 || ell < 1 || ell > 32 * W || n_rows > 65535 || max_rows > rows_cap + 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long tiles = (max_rows + UNPACK_ROWS - 1) / UNPACK_ROWS;
  const dim3 grid(static_cast<unsigned>(tiles < 65535 ? tiles : 65535),
                  static_cast<unsigned>(n_rows));
  unpack_columns_kernel<<<grid, UNPACK_THREADS, UNPACK_ROWS * W * sizeof(uint32_t),
                          static_cast<cudaStream_t>(stream)>>>(col0, cols, meta, out, W, ell,
                                                               rows_cap);
  return static_cast<int>(cudaGetLastError());
}
