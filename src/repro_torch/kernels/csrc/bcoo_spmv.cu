// Block-sparse (BCOO / BCSR) SpMV and SpMM for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/bcsr_spmv.py:bcoo_spmv_pallas.
// The TPU kernel took one grid step per nonzero (r, c) block and carried the
// block-row's sum from step to step in VMEM; blocks run in no order here, so
// the sequential grid axis becomes a loop over the block-row's blocks, found
// through the block-row pointer (BCSR's browptr, or one built once from
// BCOO's browind).  Every route writes each output once (zero for an empty
// block-row), uses no atomics, and sums in an order fixed by the matrix and
// the route alone: the batch tile never changes a bit.
//
// One C entry point, three routes; the wrapper (kernels/bcsr_spmv.py:
// block_route) picks one by (dtype, r, c, B).
//
// 1. SpMV, B = 1, c % 4 == 0 and r * c / 4 dividing 32 (the main path's
//    (8, 16) blocks): bcoo_warp_kernel.  A block-row's blocks are
//    contiguous in bvalues; lane l takes 4 consecutive values of one block
//    row (one 128-bit load for f32: a warp load covers a whole (8, 16) f32
//    block) and the matching 4 x values in one load, multiplies them in
//    column order and keeps its own sum; the lanes of a row are summed by
//    __shfl_xor_sync when the block-row ends.  A warp walks kSpmvRows
//    consecutive block-rows as one stream of blocks, kSpmvUnroll blocks'
//    indices, values and x loaded before any is multiplied, so the loads of
//    the next blocks fly across block-row ends.  Bound: bytes (each value
//    read once, evict-first; x gathers from L2).  An unaligned x (a part's
//    window) or values pointer takes scalar loads.
// 2. SpMM on the tensor cores (f32, bf16, f16; r = 8 or 16; c % 8 == 0 for
//    f32, c % 16 == 0 for 16-bit values).  A block is 8 rows high and
//    mma.m16n8k* needs 16 in M, so the batch columns go in M, the block's
//    rows in N and its columns in K: y^T[b, i] += x^T[b, k] A^T[k, i].  A
//    warp walks kMmaRows consecutive block-rows as one stream of 16-column
//    slices, with up to 16 * kMaxMTiles batch columns; it loads each
//    slice's B fragments once for all its m-tiles and keeps the
//    accumulators in registers until a block-row's y is written once.
//    f32 takes 3xTF32 (a = a_hi + a_lo by cvt.rna.tf32; a_lo x_hi +
//    a_hi x_lo + a_hi x_hi on m16n8k8): one TF32 pass keeps 10 mantissa
//    bits, about 1e-3 relative error per product, beyond the port's 2e-4;
//    with integer-valued inputs the lo parts are 0 and the sums exact.
//    The three passes of each k-step go into a fresh partial sum, which
//    one __fadd_rn adds to the accumulator (mma_3xtf32): the tensor cores
//    round their f32 accumulation toward zero, and one accumulator carried
//    through every k-step of a long block-row drifts toward zero (on the
//    H100, 2.0e-4 off the float64 product over 5,120 columns, against
//    1.6e-6 for the CUDA-core route).
//    bf16 / f16 take m16n8k16 with f32 accumulation (exact products).
//    - B > 16, bcoo_mma_kernel: each slice's values and x rows are staged in
//      the warp's own shared memory by cp.async (16-byte copies, kMmaStages
//      buffers), so the next slice's copies, mostly L2 gathers of x, fly
//      while this slice's mma run; row strides are padded so that every
//      fragment read is free of bank conflicts.  Bound: the x gathers, a
//      16 x 64 tile per block at B = 64, which the bytes bound counts once.
//    - B <= 16, bcoo_mma_reg_kernel: one m-tile, so the fragments come
//      straight from global memory into registers (see the kernel).
//      Measured on the H100: 0.15 ms at B = 8 against 0.20 staged in
//      shared memory and 0.20 on the CUDA cores.  Bound: bytes.
// 3. Everything else (integer values, blocks that do not tile, 1 < B < 8,
//    SpMV of wide blocks): bcoo_rows_kernel on the CUDA cores.  A thread
//    owns up to kRowTile rows of a block-row and one batch column, so each
//    loaded x value feeds that many MACs; the values come 4 at a time where
//    aligned.  Each row sums a block's c products in column order from 0
//    (__fmul_rn / __fadd_rn, int32 wrapping) and adds the block's sum to
//    the row's, in block order.
//
// Part axis.  In every route blockIdx.z is the part of a partitioned matrix:
// part p walks its own block-row pointer (n_brows + 1 entries per part) over
// its own cap blocks, writes its own n_brows * r x B slice of y and reads x
// from its own window x[x_offset[p] :][: n_cols], whose alignment is tested
// per part.  With one part and no x_offset it is the single-device kernel.
// Columns at or past n_cols read x as zero (a partial last block-column).

#include <string.h>

#include <type_traits>

#include "common.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kSpmvWarps = 4;   // warps per CTA, SpMV route
constexpr int kSpmvUnroll = 4;  // blocks whose loads a lane issues together
constexpr int kSpmvRows = 8;    // block-rows a warp walks, SpMV route
constexpr int kMmaWarps = 4;    // warps per CTA, mma route, B > 16
constexpr int kMaxMTiles = 4;   // 16-column m-tiles per warp, B > 16
constexpr int kMmaStages = 2;   // shared-memory stages per warp, B > 16
constexpr int kMmaRows = 4;     // block-rows a warp walks, B > 16
constexpr int kMmaRegWarps = 8;   // warps per CTA, mma route, B <= 16
constexpr int kMmaRegRows = 4;    // block-rows a warp walks, B <= 16
constexpr int kMmaRegUnroll = 1;  // slices whose loads a lane issues together
constexpr int kRowTile = 8;     // rows a thread owns, CUDA-core route
constexpr int kRowsThreads = 256;
constexpr int kSlice = 16;      // block columns staged per mma step

enum Route : int { kRows = 0, kWarp = 1, kMma = 2 };

template <typename V> struct Vec4 { using T = uint2; };  // 4 x 16-bit
template <> struct Vec4<float> { using T = float4; };
template <> struct Vec4<int32_t> { using T = int4; };
template <> struct Vec4<int8_t> { using T = uint32_t; };

// Four consecutive values at p (4 * sizeof(V)-aligned) in one load; the
// block stream is read once (evict-first), x through the read-only path.
template <typename V>
__device__ __forceinline__ void load4_stream(const V* p, V out[4]) {
  const auto t = __ldcs(reinterpret_cast<const typename Vec4<V>::T*>(p));
  memcpy(out, &t, sizeof(t));
}
template <typename V>
__device__ __forceinline__ void load4(const V* p, V out[4]) {
  const auto t = __ldg(reinterpret_cast<const typename Vec4<V>::T*>(p));
  memcpy(out, &t, sizeof(t));
}

template <typename V>
__device__ __forceinline__ V zero_of() {
  V v;
  memset(&v, 0, sizeof(V));
  return v;
}

__device__ __forceinline__ bool aligned(const void* p, size_t n) {
  return reinterpret_cast<uintptr_t>(p) % n == 0;
}

// Offsets a launch's pointers to part blockIdx.z.
template <typename V, typename Y>
struct Part {
  const int* browptr;
  const int* bcolind;
  const V* bvalues;
  const V* x;
  Y* y;
  __device__ Part(const int* browptr_, const int* bcolind_, const V* bvalues_, const V* x_,
                  Y* y_, const int* x_offset, int n_brows, int r, int c, int B, int cap) {
    const int p = blockIdx.z;
    browptr = browptr_ + static_cast<size_t>(p) * (n_brows + 1);
    bcolind = bcolind_ + static_cast<size_t>(p) * cap;
    bvalues = bvalues_ + static_cast<size_t>(p) * cap * r * c;
    y = y_ + static_cast<size_t>(p) * n_brows * r * B;
    x = x_offset != nullptr ? x_ + static_cast<size_t>(x_offset[p]) * B : x_;
  }
};

// ------------------------------------------------------------ 1. SpMV warp

template <typename V>
__global__ void __launch_bounds__(kSpmvWarps * 32)
bcoo_warp_kernel(const int* __restrict__ browptr, const int* __restrict__ bcolind,
                 const V* __restrict__ bvalues, const V* __restrict__ x,
                 typename repro::Acc<V>::type* __restrict__ y,
                 const int* __restrict__ x_offset, int n_brows, int r, int c, int n_cols,
                 int cap) {
  using A = typename repro::Acc<V>::type;
  const Part<V, A> P(browptr, bcolind, bvalues, x, y, x_offset, n_brows, r, c, 1, cap);
  const int br0 = (blockIdx.x * kSpmvWarps + threadIdx.x / 32) * kSpmvRows;
  if (br0 >= n_brows) return;
  const int br1 = min(br0 + kSpmvRows, n_brows);
  const int lane = threadIdx.x % 32;
  const int cg = c / 4;       // 4-column groups in a block row
  const int G = r * cg;       // groups in a block: divides 32
  const int S = 32 / G;       // blocks a warp step covers
  const int s = lane / G, q = lane % G;
  const int i = q / cg, j0 = 4 * (q % cg);
  const int n_bcols = (n_cols + c - 1) / c;
  const bool vvec = aligned(P.bvalues, 4 * sizeof(V));
  const bool xvec = aligned(P.x, 4 * sizeof(V));

  A acc = A(0);
  int cur = br0;  // the block-row acc belongs to
  // Sums row i of block-row cur over its lanes (column groups, then block
  // slots), writes it once and moves to the next block-row.
  auto flush = [&]() {
    for (int m = 1; m < cg; m <<= 1) acc = repro::add(acc, __shfl_xor_sync(kFull, acc, m));
    for (int m = G; m < 32; m <<= 1) acc = repro::add(acc, __shfl_xor_sync(kFull, acc, m));
    if (s == 0 && q % cg == 0) P.y[static_cast<size_t>(cur) * r + i] = acc;
    acc = A(0);
    ++cur;
  };
  // With S == 1 every lane is on the same block, so the warp walks the
  // blocks of block-rows [br0, br1) as one stream and flushes at each row's
  // end; with S > 1 it walks one block-row at a time.
  int next = P.browptr[br0 + 1];
  int k_first = P.browptr[br0];
  int k_end = S == 1 ? P.browptr[br1] : next;
  while (true) {
    for (int k = k_first + s; k < k_end; k += kSpmvUnroll * S) {
      int col[kSpmvUnroll];
#pragma unroll
      for (int u = 0; u < kSpmvUnroll; ++u) {
        const int kk = k + u * S;
        col[u] = kk < k_end ? min(P.bcolind[kk], n_bcols - 1) * c + j0 : -1;
      }
      V a[kSpmvUnroll][4], xv[kSpmvUnroll][4];
#pragma unroll
      for (int u = 0; u < kSpmvUnroll; ++u) {
        if (col[u] < 0) continue;
        const V* ap = P.bvalues + (static_cast<size_t>(k + u * S) * r + i) * c + j0;
        if (vvec) {
          load4_stream(ap, a[u]);
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e) a[u][e] = ap[e];
        }
        if (xvec && col[u] + 4 <= n_cols) {
          load4(P.x + col[u], xv[u]);
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            xv[u][e] = col[u] + e < n_cols ? P.x[col[u] + e] : zero_of<V>();
        }
      }
#pragma unroll
      for (int u = 0; u < kSpmvUnroll; ++u) {
        if (col[u] < 0) continue;
        if (S == 1) {
          while (k + u >= next) {  // block k + u starts a later block-row
            flush();
            next = P.browptr[cur + 1];
          }
        }
        A p = repro::mul(repro::to_acc(a[u][0]), repro::to_acc(xv[u][0]));
#pragma unroll
        for (int e = 1; e < 4; ++e)
          p = repro::add(p, repro::mul(repro::to_acc(a[u][e]), repro::to_acc(xv[u][e])));
        acc = repro::add(acc, p);
      }
    }
    if (S == 1) break;
    flush();
    if (cur >= br1) break;
    k_first = next;
    k_end = next = P.browptr[cur + 1];
  }
  while (cur < br1) flush();  // the last block-row, then empty ones
}

// ------------------------------------------------------ 2. SpMM tensor cores

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte cp.async (L2 only); src_bytes = 0 fills the 16 bytes with zeros.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ uint32_t tf32(float f) {
  uint32_t t;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(t) : "f"(f));
  return t;
}

// a = hi + lo, both TF32 (hi = a rounded to 10 mantissa bits, ties away).
__device__ __forceinline__ void split(float a, uint32_t& hi, uint32_t& lo) {
  hi = tf32(a);
  lo = tf32(__fsub_rn(a, __uint_as_float(hi)));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a_lo b_hi + a_hi b_lo + a_hi b_hi, summed in a fresh partial and
// added to d with one round-to-nearest add (see the file's notes: the
// tensor cores' own f32 accumulation rounds toward zero).
__device__ __forceinline__ void mma_3xtf32(float (&d)[4], const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4],
                                           const uint32_t (&bh)[2],
                                           const uint32_t (&bl)[2]) {
  float part[4] = {0.f, 0.f, 0.f, 0.f};
  mma_tf32(part, al, bh);
  mma_tf32(part, ah, bl);
  mma_tf32(part, ah, bh);
#pragma unroll
  for (int e = 0; e < 4; ++e) d[e] = __fadd_rn(d[e], part[e]);
}

template <typename V> struct Mma16;  // m16n8k16, f32 accumulation
template <> struct Mma16<__nv_bfloat16> {
  static __device__ __forceinline__ void run(float (&d)[4], const uint32_t (&a)[4],
                                             const uint32_t (&b)[2]) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
};
template <> struct Mma16<__half> {
  static __device__ __forceinline__ void run(float (&d)[4], const uint32_t (&a)[4],
                                             const uint32_t (&b)[2]) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
};

__device__ __forceinline__ uint32_t pack16(uint16_t lo, uint16_t hi) {
  return static_cast<uint32_t>(lo) | (static_cast<uint32_t>(hi) << 16);
}

// Shared-memory geometry of one stage: a slice of kSlice block columns.
// Row strides are padded by 16 bytes (values) and 8 elements (x), which
// puts the fragment reads of a warp on 32 distinct banks.
template <typename V, int MT>
struct Stage {
  static constexpr int kE = 16 / sizeof(V);       // elements per 16-byte copy
  static constexpr int kVS = kSlice + kE;         // values row stride
  static constexpr int kXW = 16 * MT;             // batch columns of a warp
  static constexpr int kXS = kXW + 8;             // x row stride
  static __host__ __device__ size_t bytes(int r) {
    return sizeof(V) * (static_cast<size_t>(r) * kVS + kSlice * kXS);
  }
};

template <typename V, int MT, int NT>
__global__ void __launch_bounds__(kMmaWarps * 32)
bcoo_mma_kernel(const int* __restrict__ browptr, const int* __restrict__ bcolind,
                const V* __restrict__ bvalues, const V* __restrict__ x,
                float* __restrict__ y, const int* __restrict__ x_offset, int n_brows,
                int c, int n_cols, int B, int cap) {
  using S = Stage<V, MT>;
  constexpr int r = 8 * NT;
  constexpr bool kF32 = sizeof(V) == 4;
  constexpr int kK = kF32 ? 8 : 16;  // mma depth
  extern __shared__ __align__(16) unsigned char smem[];
  const Part<V, float> P(browptr, bcolind, bvalues, x, y, x_offset, n_brows, r, c, B, cap);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int br0 = (blockIdx.x * kMmaWarps + warp) * kMmaRows;
  if (br0 >= n_brows) return;  // warps never synchronise across the CTA
  const int br1 = min(br0 + kMmaRows, n_brows);
  const int g = lane >> 2, t = lane & 3;
  const int b0 = blockIdx.y * S::kXW;
  const int nb = min(S::kXW, B - b0);
  const int n_bcols = (n_cols + c - 1) / c;
  const int n_slices = (c + kSlice - 1) / kSlice;
  const bool vvec = (c * sizeof(V)) % 16 == 0 && aligned(P.bvalues, 16);
  const bool xvec = (B * sizeof(V)) % 16 == 0 && aligned(P.x, 16);
  const size_t stage_bytes = S::bytes(r);
  unsigned char* base = smem + static_cast<size_t>(warp) * kMmaStages * stage_bytes;
  auto vs = [&](int st) { return reinterpret_cast<V*>(base + st * stage_bytes); };
  auto xs = [&](int st) { return vs(st) + r * S::kVS; };

  // The warp walks the blocks of block-rows [br0, br1) as one stream of
  // slices: slice u is block k_lo + u / n_slices, columns s0..s0+kSlice.
  const int k_lo = P.browptr[br0];
  const int k_end = P.browptr[br1];
  const int n_units = (k_end - k_lo) * n_slices;
  // Lane l holds the block column of block k_lo + col_base + l.
  int col_base = -32, col_reg = 0;

  // Copies slice u into stage st: the block's r rows and the x rows they
  // multiply.  Called by the whole warp, for u in increasing order.
  auto issue = [&](int st, int u) {
    const int kb = u / n_slices;
    if (kb >= col_base + 32) {
      col_base = kb & ~31;
      const int kk = k_lo + col_base + lane;
      col_reg = kk < k_end ? P.bcolind[kk] : 0;
    }
    const int k = k_lo + kb;
    const int s0 = (u % n_slices) * kSlice;
    const int col0 = min(__shfl_sync(kFull, col_reg, kb - col_base), n_bcols - 1) * c + s0;
    const int kc = min(c - s0, n_cols - col0);  // x is zero from here
    const V* bv = P.bvalues + static_cast<size_t>(k) * r * c + s0;
    if (vvec) {
      for (int q = lane; q < r * (kSlice / S::kE); q += 32) {
        const int i = q / (kSlice / S::kE), j = (q % (kSlice / S::kE)) * S::kE;
        if (s0 + j < c) cp_async16(vs(st) + i * S::kVS + j, bv + i * c + j, 16);
      }
    } else {
      for (int q = lane; q < r * kSlice; q += 32) {
        const int i = q / kSlice, j = q % kSlice;
        if (s0 + j < c) vs(st)[i * S::kVS + j] = bv[i * c + j];
      }
    }
    if (xvec) {
      constexpr int kPer = S::kXW / S::kE;
      for (int q = lane; q < kSlice * kPer; q += 32) {
        const int j = q / kPer, cc = (q % kPer) * S::kE;
        if (cc >= nb) continue;  // feeds only outputs that are never written
        const bool ok = j < kc;
        cp_async16(xs(st) + j * S::kXS + cc,
                   ok ? P.x + static_cast<size_t>(col0 + j) * B + b0 + cc : P.x, ok ? 16 : 0);
      }
    } else {
      for (int q = lane; q < kSlice * S::kXW; q += 32) {
        const int j = q / S::kXW, cc = q % S::kXW;
        xs(st)[j * S::kXS + cc] = j < kc && cc < nb
                                      ? P.x[static_cast<size_t>(col0 + j) * B + b0 + cc]
                                      : zero_of<V>();
      }
    }
  };

  float acc[MT][NT][4];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][n][e] = 0.f;

  // Writes block-row cur from the accumulators, once, and clears them.
  // D[m = batch column][n = block row]: lane holds (g, 2t), (g, 2t+1),
  // (g+8, 2t), (g+8, 2t+1) of each tile.
  int cur = br0;
  auto flush = [&]() {
#pragma unroll
    for (int m = 0; m < MT; ++m) {
#pragma unroll
      for (int n = 0; n < NT; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int b = m * 16 + g + (e >> 1) * 8;
          const int i = n * 8 + 2 * t + (e & 1);
          if (b < nb) P.y[(static_cast<size_t>(cur) * r + i) * B + b0 + b] = acc[m][n][e];
          acc[m][n][e] = 0.f;
        }
      }
    }
    ++cur;
  };
  int next = P.browptr[br0 + 1];

  // kMmaStages - 1 slices in flight ahead of the one being multiplied.
  for (int u = 0; u < kMmaStages - 1; ++u) {
    if (u < n_units) issue(u, u);
    cp_async_commit();
  }
  for (int u = 0; u < n_units; ++u) {
    const int st = u % kMmaStages;
    cp_async_wait<kMmaStages - 2>();
    __syncwarp();  // slice u landed for every lane; slice u - 1 is consumed
    const int ahead = u + kMmaStages - 1;
    if (ahead < n_units) issue(ahead % kMmaStages, ahead);
    cp_async_commit();
    while (k_lo + u / n_slices >= next) {  // slice u starts a later block-row
      flush();
      next = P.browptr[cur + 1];
    }
    const V* v = vs(st);
    const V* xt = xs(st);
    const int steps = min(kSlice, c - (u % n_slices) * kSlice) / kK;
    for (int ks = 0; ks < steps; ++ks) {
      const int k0 = ks * kK;
      if constexpr (kF32) {
        const float* vf = reinterpret_cast<const float*>(v);
        const float* xf = reinterpret_cast<const float*>(xt);
        uint32_t bh[NT][2], bl[NT][2];
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          split(vf[(n * 8 + g) * S::kVS + k0 + t], bh[n][0], bl[n][0]);
          split(vf[(n * 8 + g) * S::kVS + k0 + t + 4], bh[n][1], bl[n][1]);
        }
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          if (m * 16 >= nb) break;  // warp-uniform
          const float* xm = xf + m * 16 + g;
          uint32_t ah[4], al[4];
          split(xm[(k0 + t) * S::kXS], ah[0], al[0]);
          split(xm[(k0 + t) * S::kXS + 8], ah[1], al[1]);
          split(xm[(k0 + t + 4) * S::kXS], ah[2], al[2]);
          split(xm[(k0 + t + 4) * S::kXS + 8], ah[3], al[3]);
#pragma unroll
          for (int n = 0; n < NT; ++n) mma_3xtf32(acc[m][n], ah, al, bh[n], bl[n]);
        }
      } else {
        const uint16_t* vh = reinterpret_cast<const uint16_t*>(v);
        const uint16_t* xh = reinterpret_cast<const uint16_t*>(xt);
        uint32_t bf[NT][2];
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          const uint16_t* row = vh + (n * 8 + g) * S::kVS + k0 + 2 * t;
          bf[n][0] = *reinterpret_cast<const uint32_t*>(row);
          bf[n][1] = *reinterpret_cast<const uint32_t*>(row + 8);
        }
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          if (m * 16 >= nb) break;
          const uint16_t* xm = xh + (k0 + 2 * t) * S::kXS + m * 16 + g;
          uint32_t a[4];
          a[0] = pack16(xm[0], xm[S::kXS]);
          a[1] = pack16(xm[8], xm[S::kXS + 8]);
          a[2] = pack16(xm[8 * S::kXS], xm[9 * S::kXS]);
          a[3] = pack16(xm[8 * S::kXS + 8], xm[9 * S::kXS + 8]);
#pragma unroll
          for (int n = 0; n < NT; ++n) Mma16<V>::run(acc[m][n], a, bf[n]);
        }
      }
    }
  }
  while (cur < br1) flush();  // the last block-row, then empty ones
}

// B <= 16 (one m-tile): the same mma, with each lane loading its fragments
// straight from global memory, kMmaRegUnroll slices at a time; no shared
// memory.  Inside a 16-column slice the K order is permuted so that lane
// (g, t) owns block columns 4t..4t+3 of row g: its values come in one
// 4-wide load, as in the SpMV warp, and its x fragment from the same 4 x
// rows.  f32 k-step ks takes columns 4t + 2ks (k = t) and 4t + 2ks + 1
// (k = t + 4); 16-bit values take 4t, 4t+1 (k = 2t, 2t+1) and 4t+2, 4t+3
// (k = 2t+8, 2t+9).  Columns past c or n_cols are zero on both sides.
template <typename V, int NT>
__global__ void __launch_bounds__(kMmaRegWarps * 32)
bcoo_mma_reg_kernel(const int* __restrict__ browptr, const int* __restrict__ bcolind,
                    const V* __restrict__ bvalues, const V* __restrict__ x,
                    float* __restrict__ y, const int* __restrict__ x_offset, int n_brows,
                    int c, int n_cols, int B, int cap) {
  constexpr int r = 8 * NT;
  constexpr bool kF32 = sizeof(V) == 4;
  const Part<V, float> P(browptr, bcolind, bvalues, x, y, x_offset, n_brows, r, c, B, cap);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int br0 = (blockIdx.x * kMmaRegWarps + warp) * kMmaRegRows;
  if (br0 >= n_brows) return;
  const int br1 = min(br0 + kMmaRegRows, n_brows);
  const int g = lane >> 2, t = lane & 3;
  const int b0 = blockIdx.y * 16;
  const int nb = min(16, B - b0);
  const bool hi = g + 8 < nb;  // the lane's second batch column exists
  const int n_bcols = (n_cols + c - 1) / c;
  const int n_slices = (c + kSlice - 1) / kSlice;
  const bool vvec = c % 4 == 0 && aligned(P.bvalues, 4 * sizeof(V));
  const int k_lo = P.browptr[br0];
  const int k_end = P.browptr[br1];
  const int n_units = (k_end - k_lo) * n_slices;
  int col_base = -32, col_reg = 0;  // lane l: block column of k_lo + col_base + l

  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  int cur = br0;
  auto flush = [&]() {
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int b = g + (e >> 1) * 8;
        const int i = n * 8 + 2 * t + (e & 1);
        if (b < nb) P.y[(static_cast<size_t>(cur) * r + i) * B + b0 + b] = acc[n][e];
        acc[n][e] = 0.f;
      }
    }
    ++cur;
  };
  int next = P.browptr[br0 + 1];

  for (int u0 = 0; u0 < n_units; u0 += kMmaRegUnroll) {
    V xa[kMmaRegUnroll][4][2];    // x rows 4t..4t+3 at batch columns g, g + 8
    V vb[kMmaRegUnroll][NT][4];   // row n * 8 + g, columns 4t..4t+3
#pragma unroll
    for (int uu = 0; uu < kMmaRegUnroll; ++uu) {
      const int u = u0 + uu;
      if (u >= n_units) break;  // warp-uniform
      const int kb = u / n_slices;
      if (kb >= col_base + 32) {
        col_base = kb & ~31;
        const int kk = k_lo + col_base + lane;
        col_reg = kk < k_end ? P.bcolind[kk] : 0;
      }
      const int s0 = (u - kb * n_slices) * kSlice;
      const int j0 = s0 + 4 * t;  // the lane's first block column
      const int col0 = min(__shfl_sync(kFull, col_reg, kb - col_base), n_bcols - 1) * c;
      const V* bv = P.bvalues + static_cast<size_t>(k_lo + kb) * r * c + j0;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool ok = j0 + e < c && col0 + j0 + e < n_cols;
        const V* xp = P.x + static_cast<size_t>(col0 + j0 + e) * B + b0 + g;
        xa[uu][e][0] = ok ? xp[0] : zero_of<V>();
        xa[uu][e][1] = ok && hi ? xp[8] : zero_of<V>();
      }
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const V* row = bv + (n * 8 + g) * c;
        if (vvec && j0 + 4 <= c) {
          load4_stream(row, vb[uu][n]);
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e) vb[uu][n][e] = j0 + e < c ? row[e] : zero_of<V>();
        }
      }
    }
#pragma unroll
    for (int uu = 0; uu < kMmaRegUnroll; ++uu) {
      const int u = u0 + uu;
      if (u >= n_units) break;
      while (k_lo + u / n_slices >= next) {  // slice u starts a later block-row
        flush();
        next = P.browptr[cur + 1];
      }
      if constexpr (kF32) {
#pragma unroll
        for (int ks = 0; ks < 2; ++ks) {
          const int e0 = 2 * ks, e1 = 2 * ks + 1;
          uint32_t ah[4], al[4];
          split(xa[uu][e0][0], ah[0], al[0]);
          split(xa[uu][e0][1], ah[1], al[1]);
          split(xa[uu][e1][0], ah[2], al[2]);
          split(xa[uu][e1][1], ah[3], al[3]);
#pragma unroll
          for (int n = 0; n < NT; ++n) {
            uint32_t bh[2], bl[2];
            split(vb[uu][n][e0], bh[0], bl[0]);
            split(vb[uu][n][e1], bh[1], bl[1]);
            mma_3xtf32(acc[n], ah, al, bh, bl);
          }
        }
      } else {
        const auto h = [](V v) { return reinterpret_cast<const uint16_t&>(v); };
        uint32_t a[4];
        a[0] = pack16(h(xa[uu][0][0]), h(xa[uu][1][0]));
        a[1] = pack16(h(xa[uu][0][1]), h(xa[uu][1][1]));
        a[2] = pack16(h(xa[uu][2][0]), h(xa[uu][3][0]));
        a[3] = pack16(h(xa[uu][2][1]), h(xa[uu][3][1]));
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          uint32_t bf[2];
          bf[0] = pack16(h(vb[uu][n][0]), h(vb[uu][n][1]));
          bf[1] = pack16(h(vb[uu][n][2]), h(vb[uu][n][3]));
          Mma16<V>::run(acc[n], a, bf);
        }
      }
    }
  }
  while (cur < br1) flush();  // the last block-row, then empty ones
}

// ------------------------------------------------------- 3. CUDA-core rows

template <typename V>
__global__ void __launch_bounds__(kRowsThreads)
bcoo_rows_kernel(const int* __restrict__ browptr, const int* __restrict__ bcolind,
                 const V* __restrict__ bvalues, const V* __restrict__ x,
                 typename repro::Acc<V>::type* __restrict__ y,
                 const int* __restrict__ x_offset, int n_brows, int r, int c, int n_cols,
                 int B, int bt, int brows_per_cta, int cap) {
  using A = typename repro::Acc<V>::type;
  const Part<V, A> P(browptr, bcolind, bvalues, x, y, x_offset, n_brows, r, c, B, cap);
  const int chunks = (r + kRowTile - 1) / kRowTile;
  const int t = threadIdx.x % bt;
  const int ch = (threadIdx.x / bt) % chunks;
  const int local = threadIdx.x / (bt * chunks);
  const int br = blockIdx.x * brows_per_cta + local;
  const int b = blockIdx.y * bt + t;
  if (local >= brows_per_cta || br >= n_brows || b >= B) return;
  const int i0 = ch * kRowTile;
  const int ni = min(kRowTile, r - i0);
  const int n_bcols = (n_cols + c - 1) / c;
  const bool vvec = c % 4 == 0 && aligned(P.bvalues, 4 * sizeof(V));

  A acc[kRowTile];
#pragma unroll
  for (int ii = 0; ii < kRowTile; ++ii) acc[ii] = A(0);
  const int k_hi = P.browptr[br + 1];
  for (int k = P.browptr[br]; k < k_hi; ++k) {
    const int col0 = min(P.bcolind[k], n_bcols - 1) * c;
    const int kc = min(c, n_cols - col0);  // x is zero past n_cols
    const V* a = P.bvalues + (static_cast<size_t>(k) * r + i0) * c;
    const V* xp = P.x + static_cast<size_t>(col0) * B + b;
    A s[kRowTile];
#pragma unroll
    for (int ii = 0; ii < kRowTile; ++ii) s[ii] = A(0);
    int kk = 0;
    if (vvec) {
      for (; kk + 4 <= kc; kk += 4) {
        A xv[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) xv[e] = repro::to_acc(xp[static_cast<size_t>(kk + e) * B]);
#pragma unroll
        for (int ii = 0; ii < kRowTile; ++ii) {
          if (ii >= ni) break;
          V av[4];
          load4(a + ii * c + kk, av);
#pragma unroll
          for (int e = 0; e < 4; ++e)
            s[ii] = repro::add(s[ii], repro::mul(repro::to_acc(av[e]), xv[e]));
        }
      }
    }
    for (; kk < kc; ++kk) {
      const A xv = repro::to_acc(xp[static_cast<size_t>(kk) * B]);
#pragma unroll
      for (int ii = 0; ii < kRowTile; ++ii) {
        if (ii >= ni) break;
        s[ii] = repro::add(s[ii], repro::mul(repro::to_acc(a[ii * c + kk]), xv));
      }
    }
#pragma unroll
    for (int ii = 0; ii < kRowTile; ++ii) acc[ii] = repro::add(acc[ii], s[ii]);
  }
#pragma unroll
  for (int ii = 0; ii < kRowTile; ++ii)
    if (ii < ni) P.y[(static_cast<size_t>(br) * r + i0 + ii) * B + b] = acc[ii];
}

// --------------------------------------------------------------- launches

template <typename V, int MT, int NT>
int launch_mma(const int* browptr, const int* bcolind, const V* bvalues, const V* x, float* y,
               const int* x_offset, int n_brows, int c, int n_cols, int B, int n_parts,
               int cap, cudaStream_t s) {
  const size_t smem = kMmaWarps * kMmaStages * Stage<V, MT>::bytes(8 * NT);
  auto kernel = bcoo_mma_kernel<V, MT, NT>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int per_cta = kMmaWarps * kMmaRows;
  const dim3 grid((n_brows + per_cta - 1) / per_cta,
                  (B + Stage<V, MT>::kXW - 1) / Stage<V, MT>::kXW, n_parts);
  kernel<<<grid, kMmaWarps * 32, smem, s>>>(browptr, bcolind, bvalues, x, y, x_offset, n_brows,
                                            c, n_cols, B, cap);
  return static_cast<int>(cudaGetLastError());
}

template <typename V, int NT>
int launch_mma_tiles(const int* browptr, const int* bcolind, const V* bvalues, const V* x,
                     float* y, const int* x_offset, int n_brows, int c, int n_cols, int B,
                     int n_parts, int cap, cudaStream_t s) {
  if (B <= 16) {
    const int per_cta = kMmaRegWarps * kMmaRegRows;
    const dim3 grid((n_brows + per_cta - 1) / per_cta, (B + 15) / 16, n_parts);
    bcoo_mma_reg_kernel<V, NT><<<grid, kMmaRegWarps * 32, 0, s>>>(
        browptr, bcolind, bvalues, x, y, x_offset, n_brows, c, n_cols, B, cap);
    return static_cast<int>(cudaGetLastError());
  }
  if (B <= 32 || kMaxMTiles < 4)
    return launch_mma<V, 2, NT>(browptr, bcolind, bvalues, x, y, x_offset, n_brows, c, n_cols, B,
                                n_parts, cap, s);
  return launch_mma<V, 4, NT>(browptr, bcolind, bvalues, x, y, x_offset, n_brows, c, n_cols, B,
                              n_parts, cap, s);
}

template <typename V>
int launch_mma_route(const int* browptr, const int* bcolind, const void* bvalues, const void* x,
                     void* y, const int* x_offset, int n_brows, int r, int c, int n_cols, int B,
                     int n_parts, int cap, cudaStream_t s) {
  if constexpr (std::is_same<V, float>::value || std::is_same<V, __nv_bfloat16>::value ||
                std::is_same<V, __half>::value) {
    const int kk = sizeof(V) == 4 ? 8 : 16;
    if ((r != 8 && r != 16) || c % kk != 0) return static_cast<int>(cudaErrorInvalidValue);
    const auto* vp = static_cast<const V*>(bvalues);
    const auto* xp = static_cast<const V*>(x);
    auto* yp = static_cast<float*>(y);
    if (r == 8)
      return launch_mma_tiles<V, 1>(browptr, bcolind, vp, xp, yp, x_offset, n_brows, c, n_cols,
                                    B, n_parts, cap, s);
    return launch_mma_tiles<V, 2>(browptr, bcolind, vp, xp, yp, x_offset, n_brows, c, n_cols, B,
                                  n_parts, cap, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);  // integer values: CUDA cores
  }
}

}  // namespace

// y (n_parts, n_brows * r, B) in the accumulation dtype = blocks @ x, part p
// reading x rows [x_offset[p], x_offset[p] + n_cols) (x_offset may be null:
// every part reads x from row 0), x row-major with B columns.  route is
// 0 (CUDA cores, batch tile bt), 1 (SpMV warp) or 2 (tensor cores); a route
// that cannot take the shape or dtype is refused.  Returns the cudaError_t
// of the launch (0 on success).
extern "C" int repro_bcoo_spmv(const int* browptr, const int* bcolind,
                               const void* bvalues, const void* x, void* y,
                               const int* x_offset, int n_brows, int r, int c,
                               int n_cols, int B, int bt, int n_parts, int cap,
                               int route, int dtype, void* stream) {
  if (n_brows < 1 || r < 1 || c < 1 || n_cols < 1 || B < 1 || bt < 1 || n_parts < 1 ||
      n_parts > 65535 || cap < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (route == kWarp) {
    if (B != 1 || c % 4 != 0 || r * (c / 4) > 32 || 32 % (r * (c / 4)) != 0)
      return static_cast<int>(cudaErrorInvalidValue);
    const int per_cta = kSpmvWarps * kSpmvRows;
    const dim3 grid((n_brows + per_cta - 1) / per_cta, 1, n_parts);
    REPRO_DISPATCH_DTYPE(dtype, {
      bcoo_warp_kernel<V><<<grid, kSpmvWarps * 32, 0, s>>>(
          browptr, bcolind, static_cast<const V*>(bvalues), static_cast<const V*>(x),
          static_cast<typename repro::Acc<V>::type*>(y), x_offset, n_brows, r, c, n_cols, cap);
    });
    return static_cast<int>(cudaGetLastError());
  }
  if (route == kMma) {
    REPRO_DISPATCH_DTYPE(dtype, {
      return launch_mma_route<V>(browptr, bcolind, bvalues, x, y, x_offset, n_brows, r, c,
                                 n_cols, B, n_parts, cap, s);
    });
  }
  if (route != kRows) return static_cast<int>(cudaErrorInvalidValue);
  const int chunks = (r + kRowTile - 1) / kRowTile;
  if (chunks > kRowsThreads) return static_cast<int>(cudaErrorInvalidValue);
  bt = min(bt, kRowsThreads / chunks);  // the batch tile changes no bit
  const int brows_per_cta = kRowsThreads / (bt * chunks);
  const dim3 grid((n_brows + brows_per_cta - 1) / brows_per_cta, (B + bt - 1) / bt, n_parts);
  REPRO_DISPATCH_DTYPE(dtype, {
    bcoo_rows_kernel<V><<<grid, brows_per_cta * bt * chunks, 0, s>>>(
        browptr, bcolind, static_cast<const V*>(bvalues), static_cast<const V*>(x),
        static_cast<typename repro::Acc<V>::type*>(y), x_offset, n_brows, r, c, n_cols, B, bt,
        brows_per_cta, cap);
  });
  return static_cast<int>(cudaGetLastError());
}
