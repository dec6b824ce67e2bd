// ELL (padded-row) SpMV and SpMM for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/ell_spmv.py:ell_spmv_pallas.
// Every row is padded to K slots: colind and values are (rows, K) row-major,
// row_nnz (rows,) says how many slots of a row are real.  The TPU kernel
// took a (64-row, 128-lane) tile per grid step, gathered x for the whole
// tile, multiplied, masked the slots k >= row_nnz and summed each row.
//
// Design.  Rows [r0, r0 + R) of colind and values are one contiguous run of
// R * K elements each.  A CTA walks row tiles (r0 = tile * R, tiles
// blockIdx.x, blockIdx.x + gridDim.x, ...) and copies each tile's runs and
// its row_nnz into shared memory with cp.async.bulk (the 1-D TMA, completion
// on an mbarrier), double-buffered: the next tile's copy is in flight while
// this one is computed.  The 16-byte-aligned prefix of each run goes by TMA;
// an unaligned tail (only a last, short tile, or misaligned bases) is copied
// by the threads with ordinary loads.  R is a multiple of 16, so every full
// tile is aligned for every value type, and R is chosen per K: four CTAs
// an SM while a tile still holds 128 rows, else three with longer rows.
// (Measured on the H100: short rows gain from more CTAs and more gathers
// in flight, K = 48 from longer tiles.)
//
// Each output element (row r, batch column b) then runs its real slots
// k < min(row_nnz[r], K) in slot order, gathering x at the slot's column
// clipped to [0, n_cols) (the reference's take(mode="clip")), multiplying
// in the accumulation dtype and adding from 0; the padded slots are never
// used.  The sum order, and so every bit of y, is the thread-per-row
// kernel's, whatever the batch tile.  For SpMV (bt == 1) the CTA first
// computes every slot's product, coalesced over the tile, 4 or 8 slots a
// thread at a time (as many x gathers in flight), into a row-padded buffer (an
// odd row stride, so one thread per row reads it without bank conflicts),
// then one thread per row sums its row.
// For SpMM the bt threads of a row read each slot once from shared memory
// (a broadcast) and gather a coalesced slice of the x row.  No atomics.
//
// Bound.  Memory: every slot moves its column and value (4 + value bytes),
// row_nnz, x and y move once.  The stream is read once, by the TMA, in
// long contiguous runs; x gathers are served by L2 while x fits in it.
// Rows too long for one 16-row tile in shared memory fall back to a
// thread per (row, batch column) reading the slots from global memory.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
// Shared memory per CTA: four CTAs an SM while a tile still holds kMinRows
// rows (and each thread takes 8 slots at a time in the product pass), else
// three, for longer rows (4 slots at a time).
constexpr size_t kTileBudget = 56 * 1024;
constexpr size_t kLongRowBudget = 75 * 1024;
constexpr int kMinRows = 128;
constexpr size_t kMaxSmem = 227 * 1024;

__host__ __device__ __forceinline__ size_t align16(size_t n) { return (n + 15) & ~size_t(15); }

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// Waits for the phase of `parity` to complete; traps (a launch error, not a
// hang) if a copy never lands within about a second.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  const long long start = clock64();
  do {
    if (clock64() - start > 2000000000LL) __trap();
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// cp.async.bulk global -> shared, completion counted on bar.  dst, src and
// bytes must be multiples of 16.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
          smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// The part of a run of `bytes` at `src` that the TMA copies: its
// 16-byte-aligned prefix, or nothing when src is not aligned.
__device__ __forceinline__ uint32_t bulk_bytes(const void* src, size_t bytes) {
  return reinterpret_cast<uintptr_t>(src) % 16 ? 0u : static_cast<uint32_t>(bytes & ~size_t(15));
}

template <typename V>
struct Stage {  // one tile's copy in shared memory
  int* col;   // [R * K]
  V* val;     // [R * K]
  int* nnz;   // [R]
};

template <typename V>
__device__ __forceinline__ Stage<V> stage_at(unsigned char* base, int R, int K) {
  Stage<V> s;
  s.col = reinterpret_cast<int*>(base);
  s.val = reinterpret_cast<V*>(base + align16(sizeof(int) * R * K));
  s.nnz = reinterpret_cast<int*>(base + align16(sizeof(int) * R * K) +
                                 align16(sizeof(V) * R * K));
  return s;
}

// One thread issues the TMA copies of tile `tile` into stage s.
template <typename V>
__device__ void issue_tile(const Stage<V>& s, uint64_t* bar, const int* colind,
                           const V* values, const int* row_nnz, int tile, int R, int K,
                           int rows) {
  const int r0 = tile * R;
  const int n = min(R, rows - r0);
  const size_t e0 = static_cast<size_t>(r0) * K;
  const size_t ne = static_cast<size_t>(n) * K;
  const uint32_t bc = bulk_bytes(colind + e0, sizeof(int) * ne);
  const uint32_t bv = bulk_bytes(values + e0, sizeof(V) * ne);
  const uint32_t bn = bulk_bytes(row_nnz + r0, sizeof(int) * n);
  mbar_expect_tx(bar, bc + bv + bn);
  if (bc) bulk_load(s.col, colind + e0, bc, bar);
  if (bv) bulk_load(s.val, values + e0, bv, bar);
  if (bn) bulk_load(s.nnz, row_nnz + r0, bn, bar);
}

// Every thread copies its share of what the TMA left out of tile `tile`.
template <typename T>
__device__ void copy_tail(T* dst, const T* src, size_t n) {
  const size_t done = bulk_bytes(src, sizeof(T) * n) / sizeof(T);
  for (size_t i = done + threadIdx.x; i < n; i += kThreads) dst[i] = src[i];
}

template <typename V, int kUnroll>
__global__ void __launch_bounds__(kThreads)
ell_tile_kernel(const int* __restrict__ colind, const V* __restrict__ values,
                const int* __restrict__ row_nnz, const V* __restrict__ x,
                typename repro::Acc<V>::type* __restrict__ y, int rows, int K,
                int n_cols, int B, int bt, int R, int n_tiles, size_t stage_bytes) {
  using A = typename repro::Acc<V>::type;
  extern __shared__ __align__(16) unsigned char smem[];
  const Stage<V> st[2] = {stage_at<V>(smem, R, K), stage_at<V>(smem + stage_bytes, R, K)};
  const int Kp = K | 1;  // odd row stride of the product buffer
  A* prod = reinterpret_cast<A*>(smem + 2 * stage_bytes);
  uint64_t* bar = reinterpret_cast<uint64_t*>(
      smem + 2 * stage_bytes + (bt == 1 ? align16(sizeof(A) * R * Kp) : 0));
  const int b0 = blockIdx.y * bt;
  const int nb = min(bt, B - b0);

  if (threadIdx.x == 0) {
    mbar_init(&bar[0]);
    mbar_init(&bar[1]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0 && blockIdx.x < n_tiles)
    issue_tile(st[0], &bar[0], colind, values, row_nnz, blockIdx.x, R, K, rows);

  int it = 0;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x, ++it) {
    const int s = it & 1;
    const int next = tile + gridDim.x;
    if (threadIdx.x == 0 && next < n_tiles)  // stage s ^ 1 was freed last iteration
      issue_tile(st[s ^ 1], &bar[s ^ 1], colind, values, row_nnz, next, R, K, rows);
    const int r0 = tile * R;
    const int n = min(R, rows - r0);
    const size_t e0 = static_cast<size_t>(r0) * K;
    mbar_wait(&bar[s], (it >> 1) & 1);
    copy_tail(st[s].col, colind + e0, static_cast<size_t>(n) * K);
    copy_tail(st[s].val, values + e0, static_cast<size_t>(n) * K);
    copy_tail(st[s].nnz, row_nnz + r0, static_cast<size_t>(n));
    __syncthreads();
    const int* col = st[s].col;
    const V* val = st[s].val;
    const int* nnz = st[s].nnz;
    A* yt = y + static_cast<size_t>(r0) * B + b0;
    if (bt == 1) {
      // Products, one slot per thread, walking the tile in row-major order,
      // kUnroll slots a thread at a time so that as many x gathers are in
      // flight.
      const int total = n * K;
      int r = threadIdx.x / K, k = threadIdx.x - (threadIdx.x / K) * K;
      const int dr = kThreads / K, dk = kThreads - dr * K;
      for (int e = threadIdx.x; e < total; e += kUnroll * kThreads) {
        int slot[kUnroll], c[kUnroll];
        bool on[kUnroll];
        V v[kUnroll];
#pragma unroll
        for (int j = 0; j < kUnroll; ++j) {
          const int ej = e + j * kThreads;
          on[j] = ej < total && k < min(nnz[r], K);
          slot[j] = r * Kp + k;
          if (on[j]) {
            c[j] = min(max(col[ej], 0), n_cols - 1);
            v[j] = val[ej];
          }
          r += dr;
          k += dk;
          if (k >= K) { k -= K; ++r; }
        }
        A xv[kUnroll];
#pragma unroll
        for (int j = 0; j < kUnroll; ++j)
          if (on[j]) xv[j] = repro::to_acc(x[static_cast<size_t>(c[j]) * B + b0]);
#pragma unroll
        for (int j = 0; j < kUnroll; ++j)
          if (on[j]) prod[slot[j]] = repro::mul(repro::to_acc(v[j]), xv[j]);
      }
      __syncthreads();
      for (int i = threadIdx.x; i < n; i += kThreads) {
        const int kn = min(nnz[i], K);
        A acc = A(0);
        for (int kk = 0; kk < kn; ++kk) acc = repro::add(acc, prod[i * Kp + kk]);
        yt[static_cast<size_t>(i) * B] = acc;
      }
    } else {
      for (int i = threadIdx.x; i < n * bt; i += kThreads) {
        const int r = i / bt;
        const int t = i - r * bt;
        if (t >= nb) continue;
        const int kn = min(nnz[r], K);
        const int* cr = col + static_cast<size_t>(r) * K;
        const V* vr = val + static_cast<size_t>(r) * K;
        A acc = A(0);
        for (int kk = 0; kk < kn; ++kk) {
          const int c = min(max(cr[kk], 0), n_cols - 1);
          acc = repro::add(acc, repro::mul(repro::to_acc(vr[kk]),
                                           repro::to_acc(x[static_cast<size_t>(c) * B + b0 + t])));
        }
        yt[static_cast<size_t>(r) * B + t] = acc;
      }
    }
    // Order this tile's reads and tail writes of stage s before the TMA
    // writes of the tile after next into it.
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
  }
}

// Fallback for rows too long for a 16-row tile: a thread per (row, column)
// reading the slots from global memory, in the same order.
template <typename V>
__global__ void __launch_bounds__(kThreads)
ell_rows_kernel(const int* __restrict__ colind, const V* __restrict__ values,
                const int* __restrict__ row_nnz, const V* __restrict__ x,
                typename repro::Acc<V>::type* __restrict__ y, int rows, int K, int n_cols,
                int B, int bt, int rows_per_cta) {
  using A = typename repro::Acc<V>::type;
  const int t = threadIdx.x % bt;
  const int local = threadIdx.x / bt;
  const int r = blockIdx.x * rows_per_cta + local;
  const int b = blockIdx.y * bt + t;
  if (local >= rows_per_cta || r >= rows || b >= B) return;
  const int* ci = colind + static_cast<size_t>(r) * K;
  const V* vv = values + static_cast<size_t>(r) * K;
  const int kn = min(row_nnz[r], K);
  A acc = A(0);
  for (int k = 0; k < kn; ++k) {
    const int col = min(max(ci[k], 0), n_cols - 1);
    acc = repro::add(acc, repro::mul(repro::to_acc(vv[k]),
                                     repro::to_acc(x[static_cast<size_t>(col) * B + b])));
  }
  y[static_cast<size_t>(r) * B + b] = acc;
}

template <typename V>
size_t smem_for(int R, int K, int bt, size_t* stage_bytes) {
  using A = typename repro::Acc<V>::type;
  *stage_bytes = align16(sizeof(int) * R * K) + align16(sizeof(V) * R * K) +
                 align16(sizeof(int) * R);
  return 2 * *stage_bytes + (bt == 1 ? align16(sizeof(A) * R * (K | 1)) : 0) +
         2 * sizeof(uint64_t);
}

template <typename V>
int launch(const int* colind, const void* values, const int* row_nnz, const void* x,
           void* y, int rows, int K, int n_cols, int B, int bt, cudaStream_t stream) {
  using A = typename repro::Acc<V>::type;
  const auto* vp = static_cast<const V*>(values);
  const auto* xp = static_cast<const V*>(x);
  auto* yp = static_cast<A*>(y);
  const dim3 tiles_b(1, (B + bt - 1) / bt);
  // Rows per tile: a multiple of 16 under the budget, no more than needed.
  size_t stage_bytes = 0;
  const size_t per16 = smem_for<V>(16, K, bt, &stage_bytes);
  if (per16 > kMaxSmem) {
    const int rows_per_cta = max(1, kThreads / bt);
    const dim3 grid((rows + rows_per_cta - 1) / rows_per_cta, tiles_b.y);
    ell_rows_kernel<V><<<grid, rows_per_cta * bt, 0, stream>>>(
        colind, vp, row_nnz, xp, yp, rows, K, n_cols, B, bt, rows_per_cta);
    return static_cast<int>(cudaGetLastError());
  }
  const int r_cap = min(1024, (rows + 15) / 16 * 16);
  const bool short_rows = smem_for<V>(min(kMinRows, r_cap), K, bt, &stage_bytes) <= kTileBudget;
  const size_t budget = short_rows ? kTileBudget : kLongRowBudget;
  int R = 16;
  while (R + 16 <= r_cap && smem_for<V>(R + 16, K, bt, &stage_bytes) <= budget) R += 16;
  const size_t smem = smem_for<V>(R, K, bt, &stage_bytes);
  auto kernel = short_rows ? ell_tile_kernel<V, 8> : ell_tile_kernel<V, 4>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem)) !=
          cudaSuccess)
    return static_cast<int>(err);
  const int n_tiles = (rows + R - 1) / R;
  const int ctas = max(1, min(n_tiles, max(1, per_sm) * sms));
  kernel<<<dim3(ctas, tiles_b.y), kThreads, smem, stream>>>(
      colind, vp, row_nnz, xp, yp, rows, K, n_cols, B, bt, R, n_tiles, stage_bytes);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// y (rows, B) in the accumulation dtype = ELL(colind, values, row_nnz) @ x,
// x (n_cols, B) row-major.  Returns the cudaError_t of the launch (0 on
// success).
extern "C" int repro_ell_spmv(const int* colind, const void* values,
                              const int* row_nnz, const void* x, void* y,
                              int rows, int K, int n_cols, int B, int bt,
                              int dtype, void* stream) {
  if (rows < 1 || K < 1 || n_cols < 1 || B < 1 || bt < 1 || bt > 32)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  REPRO_DISPATCH_DTYPE(dtype, {
    return launch<V>(colind, values, row_nnz, x, y, rows, K, n_cols, B, bt, s);
  });
  return 0;
}
