// Windowed COO / CSR SpMV and SpMM for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/coo_spmv.py:coo_spmv_pallas
// (and csr_spmv_pallas, which is the same kernel fed a row-granular plan).
// It runs the same ChunkPlan: chunks of at most E row-sorted nonzeros, each
// confined to one SPAN-row output window, with window ids non-decreasing.
//
// Pieces.  The host cuts each window's contiguous chunk range into pieces
// of at most M chunks (kernels/coo_spmv.py:plan_pieces, built once with the
// plan, M = 16), so work is balanced by nonzeros, not by windows: a window
// holding one dense row of 4,096 chunks becomes 256 CTAs instead of one
// (paper Obs. 4).  Pass 1 runs one CTA per (piece, batch tile), the batch
// tile fastest so that the tiles of a piece share its chunks through L2, and
// accumulates the piece into a SPAN x bt tile in shared memory.  A window
// that is a single piece writes its tile to y, zeros included, so empty
// windows need no second pass.  The pieces of a split window write their
// tiles to a scratch slot each, and pass 2 (coo_merge_kernel, launched
// right after by the same entry point) sums each window's slots in piece
// order into y.  The part axis of a stacked plan is flattened into the
// piece list (part = piece / Q), so one launch serves every part.
//
// Sum order.  Every output element's additions run in an order fixed by
// the plan alone: stream order inside a chunk (a row's products summed one
// after another), chunk order inside a piece (the boundary rows of each
// chunk, which may continue in a neighbouring chunk, are added into the
// tile in chunk order after each round), piece order inside a window.  So
// the result does not depend on the batch tile or on B: an SpMM column
// equals the SpMV of that column to the bit.  No atomics.
//
// Two ways to walk a chunk, both in that order:
//  * bt == 1 (SpMV): 4 warps, one per chunk (small CTAs, so that the
//    many short pieces of a tall part-axis plan keep the SMs full).  Pass A
//    reads the chunk with 128-bit evict-first loads, 4 consecutive elements
//    per lane, the next 128 elements loading while this block's 4 x gathers
//    per lane are in flight; it writes each product to shared memory and
//    records where the row segments start.  Pass B gives each segment to
//    one lane, which sums its products in stream order.  Products are
//    stored one pad word per 32 so that lanes summing segments 2^k apart
//    hit distinct banks.
//  * bt >= 2 (SpMM): lanes over batch columns.  A group of G lanes (G the
//    power of two >= bt) owns one chunk; it reads G elements at a time,
//    coalesced, broadcasts each with __shfl_sync, and lane t adds
//    v * x[col, b0 + t]: one coalesced x-row read per nonzero, no per-column
//    scan.  A running sum per lane is flushed when the row changes.  With
//    G < 32 the spare lanes of a warp own other chunks, never other
//    elements of the same chunk, and the CTA has G / 2 warps (16 chunks a
//    round, a regular window's chunks) so that no warp idles on a short
//    piece; at G = 32 it has 8 warps, three CTAs an SM.  The next G
//    elements load while this step's x rows are gathered.
//
// Bound.  Memory: each nonzero moves its row, column and value (8 + value
// bytes), x and y move once.  The design reads the nonzero stream once,
// coalesced, keeps every partial sum on chip (registers, shared memory)
// and writes y once; scratch adds 2 x SPAN x B words per piece of a split
// window.  The random x gathers are served by L2 while x fits in it.
//
// Part axis.  The partitioned schemes (repro/core/distributed.py) run this
// kernel once per part of a PartitionedMatrix: part p reads its own slice of
// the stacked plan (n_chunks chunks per part), writes its own out_rows x B
// slice of y, and gathers x from its own window x[x_offset[p] :][: n_cols]
// (the reference's x_local), clipping every column to that window.

#include "common.cuh"

namespace {

constexpr int kWarps = 8;  // warps of a CTA at most
constexpr int kThreads = kWarps * 32;
constexpr int kSpmvWarps = 4;  // warps of an SpMV CTA, one chunk each
// CTAs an SM must hold at G = 32: caps the registers (G products a lane)
// so that three 8-warp CTAs stay resident and keep more x gathers in flight.
constexpr int kWideMinBlocks = 3;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxE = 2048;  // chunk width: bounds the per-warp product buffer

// SpMV loads of the nonzero stream, which is read once and in whole lines:
// evict-first (ld.global.cs), so that x keeps its place in L2.  (The SpMM
// groups read a line over several steps and keep the default policy.)
template <typename T>
__device__ __forceinline__ T ld_stream(const T* p) {
  return __ldcs(p);
}

// Product slot of element e: one pad word per 32 words.
__device__ __forceinline__ int pad(int e) { return e + (e >> 5); }

template <typename V> struct Vec4 { using T = uint2; };  // 4 x 16-bit
template <> struct Vec4<float> { using T = float4; };
template <> struct Vec4<int32_t> { using T = int4; };
template <> struct Vec4<int8_t> { using T = uint32_t; };

// Four consecutive values of p, 4 * sizeof(V)-aligned, in one load.
template <typename V>
__device__ __forceinline__ void load4(const V* p, V out[4]) {
  const typename Vec4<V>::T t = ld_stream(reinterpret_cast<const typename Vec4<V>::T*>(p));
  memcpy(out, &t, sizeof(t));
}

__device__ __forceinline__ int clip(int c, int n) { return min(max(c, 0), n - 1); }

template <typename V>
struct Plan {
  const int* count;
  const int* rowind;
  const int* colind;
  const V* values;
  const V* x;
  int E, n_cols, B, b0, nb, bt, vec;
};

// Boundary records of one round: two per chunk (its first and last row).
template <typename A>
struct Records {
  A* sum;    // [chunks per round][2][width]
  int* row;  // [chunks per round][2]
  int width;
  __device__ void put(int q, int s, int r, int t, A v) const {
    sum[(q * 2 + s) * width + t] = v;
    if (t == 0) row[q * 2 + s] = r;
  }
};

// Elements [e0, e0 + 4) of a chunk of cnt: rows (-1 past cnt), columns
// and values, by 128-bit loads when the plan is aligned for them.
template <typename V>
__device__ __forceinline__ void load_block(const int* ri, const int* ci, const V* vv,
                                           int e0, int cnt, int vec, int r[4], int c[4],
                                           V v[4]) {
#pragma unroll
  for (int k = 0; k < 4; ++k) { r[k] = -1; c[k] = 0; }
  if (e0 >= cnt) return;
  if (vec) {  // [e0, e0 + 4) lies inside the chunk's E slots
    const int4 r4 = ld_stream(reinterpret_cast<const int4*>(ri + e0));
    const int4 c4 = ld_stream(reinterpret_cast<const int4*>(ci + e0));
    load4(vv + e0, v);
    r[0] = r4.x; r[1] = r4.y; r[2] = r4.z; r[3] = r4.w;
    c[0] = c4.x; c[1] = c4.y; c[2] = c4.z; c[3] = c4.w;
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (e0 + k >= cnt) r[k] = -1;
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (e0 + k < cnt) {
        r[k] = ld_stream(ri + e0 + k);
        c[k] = ld_stream(ci + e0 + k);
        v[k] = ld_stream(vv + e0 + k);
      }
  }
}

// bt == 1: warp `warp` merges chunk j of the plan into the tile.
template <typename V, typename A>
__device__ void chunk_by_warp(const Plan<V>& pl, int j, int q, A* tile,
                              const Records<A>& rec, A* prod, uint32_t* seg,
                              int lane) {
  const int cnt = pl.count[j];
  const size_t off = static_cast<size_t>(j) * pl.E;
  const int* ri = pl.rowind + off;
  const int* ci = pl.colind + off;
  const V* vv = pl.values + off;
  // Pass A: products to shared memory, segment starts to `seg`
  // (row << 16 | first element).  The next block's indices and values are
  // loaded while this block's x gathers are in flight.
  int nseg = 0;
  int carry = -1;  // row of the element before this block
  const unsigned lt = (1u << lane) - 1u;
  int r[4], c[4];
  V v[4];
  load_block(ri, ci, vv, 4 * lane, cnt, pl.vec, r, c, v);
  for (int s0 = 0; s0 < cnt; s0 += 128) {
    const int e0 = s0 + 4 * lane;
    A p[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (e0 + k < cnt) {
        const V xv = pl.x[static_cast<size_t>(clip(c[k], pl.n_cols)) * pl.B + pl.b0];
        p[k] = repro::mul(repro::to_acc(v[k]), repro::to_acc(xv));
      }
    }
    int rn[4], cn[4];
    V vn[4];
    load_block(ri, ci, vv, e0 + 128, cnt, pl.vec, rn, cn, vn);
    int prev = __shfl_up_sync(kFull, r[3], 1);
    if (lane == 0) prev = carry;
    bool flag[4];
    unsigned m[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      flag[k] = e0 + k < cnt && (e0 + k == 0 || r[k] != (k == 0 ? prev : r[k - 1]));
      m[k] = __ballot_sync(kFull, flag[k]);
    }
    int idx = nseg;
#pragma unroll
    for (int k = 0; k < 4; ++k) idx += __popc(m[k] & lt);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (flag[k]) seg[idx++] = (static_cast<uint32_t>(r[k]) << 16) | (e0 + k);
      if (e0 + k < cnt) prod[pad(e0 + k)] = p[k];
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) nseg += __popc(m[k]);
    carry = __shfl_sync(kFull, r[3], 31);
#pragma unroll
    for (int k = 0; k < 4; ++k) { r[k] = rn[k]; c[k] = cn[k]; v[k] = vn[k]; }
  }
  if (lane == 0) seg[nseg] = static_cast<uint32_t>(cnt);
  __syncwarp();
  // Pass B: one lane per segment, in stream order.  The first segment (the
  // chunk's first row) and the last may continue in a neighbouring chunk:
  // they go to the boundary records; the others are this chunk's alone.
  for (int g = lane; g < nseg; g += 32) {
    const uint32_t sg = seg[g];
    const int lo = sg & 0xffffu;
    const int hi = seg[g + 1] & 0xffffu;
    const int row = sg >> 16;
    A s = prod[pad(lo)];
#pragma unroll 4
    for (int e = lo + 1; e < hi; ++e) s = repro::add(s, prod[pad(e)]);
    if (g == 0) rec.put(q, 0, row, 0, s);
    else if (g == nseg - 1) rec.put(q, 1, row, 0, s);
    else tile[row] = s;
  }
  if (lane == 0) {
    if (nseg < 1) rec.row[q * 2] = -1;
    if (nseg < 2) rec.row[q * 2 + 1] = -1;
  }
}

// bt >= 2: the group of G lanes at `lane0` of a warp merges chunk j (or
// nothing, j < 0) into the tile, lane t on batch column b0 + t.
template <typename V, typename A, int G>
__device__ void chunk_by_group(const Plan<V>& pl, int j, int q, A* tile,
                               const Records<A>& rec, int lane) {
  const int t = lane & (G - 1);
  const unsigned gmask =
      G >= 32 ? kFull : ((1u << (G % 32)) - 1u) << (lane & ~(G - 1));
  const int cnt = j >= 0 ? pl.count[j] : 0;
  const size_t off = static_cast<size_t>(max(j, 0)) * pl.E;
  const int* ri = pl.rowind + off;
  const int* ci = pl.colind + off;
  const V* vv = pl.values + off;
  const bool live = t < pl.nb;
  const V* xt = pl.x + pl.b0 + t;
  int cur = -1;
  int flushed = 0;
  A s = A(0);
  // Lane t holds element s0 + t of the step; the next step's element is
  // loaded while this step's x rows are gathered.
  int my_r = -1, my_c = 0;
  A my_v = A(0);
  if (t < cnt) { my_r = ri[t]; my_c = clip(ci[t], pl.n_cols); my_v = repro::to_acc(vv[t]); }
  for (int s0 = 0; s0 < cnt; s0 += G) {
    A p[G];
#pragma unroll
    for (int k = 0; k < G; ++k) {
      const int ck = __shfl_sync(gmask, my_c, k, G);
      const A vk = __shfl_sync(gmask, my_v, k, G);
      p[k] = live && s0 + k < cnt
                 ? repro::mul(vk, repro::to_acc(xt[static_cast<size_t>(ck) * pl.B]))
                 : A(0);
    }
    const int e = s0 + G + t;
    int nr = -1, nc = 0;
    A nv = A(0);
    if (e < cnt) { nr = ri[e]; nc = clip(ci[e], pl.n_cols); nv = repro::to_acc(vv[e]); }
#pragma unroll
    for (int k = 0; k < G; ++k) {
      const int rk = __shfl_sync(gmask, my_r, k, G);
      if (s0 + k < cnt) {
        if (rk != cur) {
          if (cur >= 0) {
            if (flushed++ == 0) { if (live) rec.put(q, 0, cur, t, s); }
            else if (live) tile[cur * pl.bt + t] = s;
          }
          cur = rk;
          s = p[k];
        } else {
          s = repro::add(s, p[k]);
        }
      }
    }
    my_r = nr;
    my_c = nc;
    my_v = nv;
  }
  if (j < 0) return;
  if (cnt > 0 && live) rec.put(q, flushed == 0 ? 0 : 1, cur, t, s);
  if (t == 0) {
    if (cnt == 0) rec.row[q * 2] = -1;
    if (cnt == 0 || flushed == 0) rec.row[q * 2 + 1] = -1;
  }
}

// Warps of a pass-1 CTA: 8 for SpMV; for SpMM enough groups of G lanes
// for 16 chunks a round (a regular window's 16 chunks in one round), so
// that no warp of a short piece idles.
__host__ __device__ constexpr int warps_for(int G) {
  return G == 1 ? kSpmvWarps : G == 32 ? kWarps : (G / 2 < 1 ? 1 : G / 2);
}

// Pass 1: one CTA per (piece, batch tile), the batch tile fastest, so the
// tiles of a piece run side by side and share its chunks through L2.
// pieces is (P * Q) x {window, first chunk, end chunk, scratch slot}; a
// window < 0 marks padding.
template <typename V, int G>
__global__ void __launch_bounds__(kThreads, G == 32 ? kWideMinBlocks : 1)
coo_piece_kernel(const int4* __restrict__ pieces,
                 const int* __restrict__ count,
                 const int* __restrict__ rowind,
                 const int* __restrict__ colind,
                 const V* __restrict__ values,
                 const V* __restrict__ x,
                 typename repro::Acc<V>::type* __restrict__ y,
                 const int* __restrict__ x_offset,
                 typename repro::Acc<V>::type* __restrict__ scratch,
                 int Q, int Z, int E, int span, int out_rows, int n_cols, int B,
                 int bt, int n_chunks, int vec) {
  using A = typename repro::Acc<V>::type;
  constexpr int kCtaWarps = warps_for(G);
  constexpr int kCta = kCtaWarps * 32;
  constexpr int kPerRound = G == 1 ? kCtaWarps : kCtaWarps * (32 / G);  // chunks
  constexpr int kWidth = G == 1 ? 1 : G;
  extern __shared__ __align__(16) unsigned char smem[];
  A* tile = reinterpret_cast<A*>(smem);                         // [span][bt]
  A* bsum = tile + static_cast<size_t>(span) * bt;               // [kPerRound][2][kWidth]
  int* brow = reinterpret_cast<int*>(bsum + kPerRound * 2 * kWidth);  // [kPerRound][2]

  const int n_bt = (B + bt - 1) / bt;
  const int piece = blockIdx.x / n_bt;
  const int4 pc = pieces[piece];
  if (pc.x < 0) return;  // padding row of a part with fewer pieces
  const int part = piece / Q;
  const int w = pc.x, c_lo = pc.y, c_hi = pc.z, slot = pc.w;
  const size_t pbase = static_cast<size_t>(part) * n_chunks;
  Plan<V> pl{count + pbase, rowind + pbase * E, colind + pbase * E,
             values + pbase * E,
             x + (x_offset != nullptr ? static_cast<size_t>(x_offset[part]) * B : 0),
             E, n_cols, B, static_cast<int>(blockIdx.x - piece * n_bt) * bt, 0, bt,
             vec};
  pl.nb = min(bt, B - pl.b0);
  const Records<A> rec{bsum, brow, kWidth};
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  for (int i = threadIdx.x; i < span * bt; i += kCta) tile[i] = A(0);
  __syncthreads();

  for (int base = c_lo; base < c_hi; base += kPerRound) {
    if constexpr (G == 1) {
      const int per_warp = E + (E >> 5) + 1;
      A* prod = reinterpret_cast<A*>(brow + kPerRound * 2) +
                static_cast<size_t>(warp) * (per_warp + E + 1);
      uint32_t* seg = reinterpret_cast<uint32_t*>(prod + per_warp);
      if (base + warp < c_hi)
        chunk_by_warp(pl, base + warp, warp, tile, rec, prod, seg, lane);
    } else {
      const int q = warp * (32 / G) + lane / G;
      chunk_by_group<V, A, G>(pl, base + q < c_hi ? base + q : -1, q, tile, rec,
                              lane);
    }
    __syncthreads();
    // Boundary rows, in chunk order: one thread per batch column.
    if (threadIdx.x < pl.nb) {
      const int t = threadIdx.x;
      const int nq = min(kPerRound, c_hi - base);
      for (int q = 0; q < nq; ++q) {
        for (int s = 0; s < 2; ++s) {
          const int r = brow[q * 2 + s];
          if (r >= 0) {
            A* dst = tile + static_cast<size_t>(r) * bt + t;
            *dst = repro::add(*dst, bsum[(q * 2 + s) * kWidth + t]);
          }
        }
      }
    }
    __syncthreads();
  }

  const int row0 = w * span;
  const int nrows = max(0, min(span, out_rows - row0));
  A* dst = slot < 0
               ? y + static_cast<size_t>(part) * out_rows * B + static_cast<size_t>(row0) * B
               : scratch + (static_cast<size_t>(part) * Z + slot) * span * B;
  dst += pl.b0;
  for (int i = threadIdx.x; i < nrows * pl.nb; i += kCta) {
    const int r = i / pl.nb;
    const int t = i - r * pl.nb;
    dst[static_cast<size_t>(r) * B + t] = tile[static_cast<size_t>(r) * bt + t];
  }
}

// Pass 2: one CTA row per scratch slot; the slot that opens a split window
// sums that window's slots in piece order into y.  splits is (P * Z) x
// {window, first slot, end slot}; a window < 0 marks padding.
template <typename A>
__global__ void __launch_bounds__(kThreads)
coo_merge_kernel(const int* __restrict__ splits, const A* __restrict__ scratch,
                 A* __restrict__ y, int Z, int span, int out_rows, int B) {
  const int i = blockIdx.x;
  const int part = i / Z;
  const int w = splits[3 * i], lo = splits[3 * i + 1], hi = splits[3 * i + 2];
  if (w < 0 || i - part * Z != lo) return;
  const int row0 = w * span;
  const size_t n = static_cast<size_t>(max(0, min(span, out_rows - row0))) * B;
  const size_t stride = static_cast<size_t>(span) * B;
  const A* src = scratch + (static_cast<size_t>(part) * Z + lo) * stride;
  A* dst = y + static_cast<size_t>(part) * out_rows * B + static_cast<size_t>(row0) * B;
  for (size_t k = static_cast<size_t>(blockIdx.y) * kThreads + threadIdx.x; k < n;
       k += static_cast<size_t>(gridDim.y) * kThreads) {
    A s = src[k];
    for (int z = 1; z < hi - lo; ++z) s = repro::add(s, src[z * stride + k]);
    dst[k] = s;
  }
}

template <typename V, int G>
int launch(const int* pieces, const int* splits, const int* count,
           const int* rowind, const int* colind, const void* values,
           const void* x, void* y, const int* x_offset, void* scratch, int n_parts,
           int Q, int Z, int E, int span, int out_rows, int n_cols, int B, int bt,
           int n_chunks, cudaStream_t stream) {
  using A = typename repro::Acc<V>::type;
  constexpr int kCtaWarps = warps_for(G);
  constexpr int kPerRound = G == 1 ? kCtaWarps : kCtaWarps * (32 / G);
  constexpr int kWidth = G == 1 ? 1 : G;
  size_t smem = sizeof(A) * (static_cast<size_t>(span) * bt + kPerRound * 2 * kWidth) +
                sizeof(int) * kPerRound * 2;
  if (G == 1)  // per warp: padded products and segment starts
    smem += static_cast<size_t>(kCtaWarps) * 4 * (2 * static_cast<size_t>(E) + (E >> 5) + 2);
  auto kernel = coo_piece_kernel<V, G>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const auto* vp = static_cast<const V*>(values);
  const int vec = E % 4 == 0 && reinterpret_cast<uintptr_t>(rowind) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(colind) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(vp) % (4 * sizeof(V)) == 0;
  auto* yp = static_cast<A*>(y);
  auto* sp = static_cast<A*>(scratch);
  const unsigned grid = static_cast<unsigned>(n_parts) * Q * ((B + bt - 1) / bt);
  kernel<<<grid, kCtaWarps * 32, smem, stream>>>(
      reinterpret_cast<const int4*>(pieces), count, rowind, colind, vp,
      static_cast<const V*>(x), yp, x_offset, sp, Q, Z, E, span, out_rows, n_cols,
      B, bt, n_chunks, vec);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || Z == 0) return static_cast<int>(err);
  const size_t tiles = (static_cast<size_t>(span) * B + kThreads - 1) / kThreads;
  const unsigned gy = static_cast<unsigned>(tiles < 1024 ? tiles : 1024);
  coo_merge_kernel<A><<<dim3(n_parts * Z, gy), kThreads, 0, stream>>>(
      splits, sp, yp, Z, span, out_rows, B);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// y (n_parts, out_rows, B) in the accumulation dtype = plan @ x, part p
// reading x rows [x_offset[p], x_offset[p] + n_cols) (x_offset may be null:
// every part reads x from row 0), x row-major with B columns.  pieces is
// (n_parts, Q, 4) and splits (n_parts, Z, 3) int32 (kernels/coo_spmv.py:
// plan_pieces); scratch holds n_parts * Z * span * B accumulators (null when
// Z == 0).  Returns the cudaError_t of the launches (0 on success).
extern "C" int repro_coo_spmv(const int* pieces, const int* splits,
                              const int* count, const int* rowind,
                              const int* colind, const void* values,
                              const void* x, void* y, const int* x_offset,
                              void* scratch, int Q, int Z, int E, int span,
                              int out_rows, int n_cols, int B, int bt, int n_parts,
                              int n_chunks, int dtype, void* stream) {
  if (Q < 1 || Z < 0 || E < 1 || E > kMaxE || span < 1 || span > 65535 || B < 1 ||
      bt < 1 || bt > 32 || n_cols < 1 || n_parts < 1 || n_chunks < 0 ||
      (Z > 0 && scratch == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define REPRO_COO_ARGS                                                              \
  pieces, splits, count, rowind, colind, values, x, y, x_offset, scratch, n_parts, \
      Q, Z, E, span, out_rows, n_cols, B, bt, n_chunks, s
  REPRO_DISPATCH_DTYPE(dtype, {
    if (bt == 1) return launch<V, 1>(REPRO_COO_ARGS);
    if (bt <= 2) return launch<V, 2>(REPRO_COO_ARGS);
    if (bt <= 4) return launch<V, 4>(REPRO_COO_ARGS);
    if (bt <= 8) return launch<V, 8>(REPRO_COO_ARGS);
    if (bt <= 16) return launch<V, 16>(REPRO_COO_ARGS);
    return launch<V, 32>(REPRO_COO_ARGS);
  });
#undef REPRO_COO_ARGS
  return 0;
}
