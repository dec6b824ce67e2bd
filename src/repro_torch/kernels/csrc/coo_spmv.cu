// Windowed COO / CSR SpMV and SpMM for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/coo_spmv.py:coo_spmv_pallas
// (and csr_spmv_pallas, which is the same kernel fed a row-granular plan).
// It runs the same ChunkPlan: chunks of at most E row-sorted nonzeros, each
// confined to one SPAN-row output window, with window ids non-decreasing.
//
// Design.  One CTA of 8 warps per (window, batch tile).  The CTA walks its
// window's contiguous chunk range [window_start[w], window_start[w+1]) in
// rounds, one chunk per warp per round, and accumulates into a SPAN x bt
// tile in shared memory.  A warp merges its chunk 32 elements at a time
// with a segmented inclusive scan over the row-sorted lanes (the paper's
// lock-free `lf` merge, in place of the TPU's one-hot MXU matmul), carrying
// the open row from one step to the next.  Rows that begin and end inside
// one chunk belong to that chunk alone and are stored straight into the
// tile; the chunk's first and last rows may continue in a neighbouring
// chunk, so their sums go to a small boundary record that one thread per
// batch column adds into the tile in chunk order after each round.  No
// atomics: every sum is taken in a fixed order that does not depend on the
// batch tile, so the result is deterministic and tile-invariant.  Elements
// at or past a chunk's count are never read.  The window is written once,
// zeros included, so untouched rows and windows need no second pass.
//
// Bound.  Memory: each nonzero moves its row, column and value (8 + value
// bytes), x and y move once.  The design reads the nonzero stream once,
// 32 consecutive elements per warp load (coalesced), keeps every partial
// sum on chip (registers, then the shared tile) and writes y once; the
// random x gathers are served by L2 while x fits in it (~50 MB).
// Known weakness (paper Obs. 4): a window holding one very dense row is
// walked by a single CTA.
//
// Part axis.  The partitioned schemes (repro/core/distributed.py) run this
// kernel once per part of a PartitionedMatrix.  blockIdx.z is the part:
// part p reads its own slice of the stacked plan (n_chunks chunks and
// n_windows + 1 window starts per part), writes its own out_rows x B slice
// of y, and gathers x from its own window x[x_offset[p] :][: n_cols] (the
// reference's x_local), clipping every column to that window.  One launch
// serves every part that lies on the card, as one shard_map step serves
// every device.  With one part and no x_offset the kernel is the
// single-device kernel, to the bit.

#include "common.cuh"

namespace {

constexpr int kWarps = 8;
constexpr unsigned kFull = 0xffffffffu;

template <typename V, int BT>
__global__ void __launch_bounds__(kWarps * 32)
coo_window_kernel(const int* __restrict__ window_start,
                  const int* __restrict__ count,
                  const int* __restrict__ rowind,
                  const int* __restrict__ colind,
                  const V* __restrict__ values,
                  const V* __restrict__ x,
                  typename repro::Acc<V>::type* __restrict__ y,
                  const int* __restrict__ x_offset,
                  int E, int span, int out_rows, int n_cols, int B, int bt,
                  int n_chunks) {
  using A = typename repro::Acc<V>::type;
  extern __shared__ __align__(16) unsigned char smem[];
  A* tile = reinterpret_cast<A*>(smem);                        // [span][bt]
  A* bsum = tile + static_cast<size_t>(span) * bt;              // [kWarps][2][BT]
  int* brow = reinterpret_cast<int*>(bsum + kWarps * 2 * BT);  // [kWarps][2]

  const int part = blockIdx.z;
  window_start += static_cast<size_t>(part) * (gridDim.x + 1);
  count += static_cast<size_t>(part) * n_chunks;
  rowind += static_cast<size_t>(part) * n_chunks * E;
  colind += static_cast<size_t>(part) * n_chunks * E;
  values += static_cast<size_t>(part) * n_chunks * E;
  y += static_cast<size_t>(part) * out_rows * B;
  if (x_offset != nullptr) x += static_cast<size_t>(x_offset[part]) * B;

  const int w = blockIdx.x;
  const int b0 = blockIdx.y * bt;
  const int nb = min(bt, B - b0);  // columns of this tile (ragged last tile)
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  for (int i = threadIdx.x; i < span * bt; i += blockDim.x) tile[i] = A(0);
  __syncthreads();

  const int c_lo = window_start[w];
  const int c_hi = window_start[w + 1];
  for (int base = c_lo; base < c_hi; base += kWarps) {
    if (lane < 2) brow[warp * 2 + lane] = -1;
    __syncwarp();
    const int j = base + warp;
    const int cnt = j < c_hi ? count[j] : 0;
    if (cnt > 0) {
      const int* ri = rowind + static_cast<size_t>(j) * E;
      const int* ci = colind + static_cast<size_t>(j) * E;
      const V* vv = values + static_cast<size_t>(j) * E;
      const int first_row = ri[0];
      const int last_row = ri[cnt - 1];
      A carry[BT];
#pragma unroll
      for (int t = 0; t < BT; ++t) carry[t] = A(0);
      int carry_row = -1;
      for (int s0 = 0; s0 < cnt; s0 += 32) {
        const int e = s0 + lane;
        const bool valid = e < cnt;
        const int row = valid ? ri[e] : -2;
        A val[BT];
#pragma unroll
        for (int t = 0; t < BT; ++t) val[t] = A(0);
        if (valid) {
          const int col = min(ci[e], n_cols - 1);
          const A v = repro::to_acc(vv[e]);
          const V* xr = x + static_cast<size_t>(col) * B + b0;
#pragma unroll
          for (int t = 0; t < BT; ++t)
            if (t < nb) val[t] = repro::mul(v, repro::to_acc(xr[t]));
        }
        // Segmented inclusive scan: lanes holding the same row are
        // contiguous, so lane-d is in my segment iff it holds my row.
#pragma unroll
        for (int d = 1; d < 32; d <<= 1) {
          const int orow = __shfl_up_sync(kFull, row, d);
          const bool take = lane >= d && orow == row;
#pragma unroll
          for (int t = 0; t < BT; ++t) {
            if (t < nb) {  // nb is uniform across the CTA
              const A o = __shfl_up_sync(kFull, val[t], d);
              if (take) val[t] = repro::add(o, val[t]);
            }
          }
        }
        if (row == carry_row) {
#pragma unroll
          for (int t = 0; t < BT; ++t) val[t] = repro::add(carry[t], val[t]);
        }
        const int next_row = __shfl_down_sync(kFull, row, 1);
        const int cont_row = s0 + 32 < cnt ? ri[s0 + 32] : -3;
        const bool tail = valid && (lane == 31 || next_row != row);
        const bool open = lane == 31 && valid && cont_row == row;
        if (tail && !open) {
          if (row == first_row || row == last_row) {
            const int slot = warp * 2 + (row == first_row ? 0 : 1);
            brow[slot] = row;
#pragma unroll
            for (int t = 0; t < BT; ++t)
              if (t < nb) bsum[slot * BT + t] = val[t];
          } else {
            A* dst = tile + static_cast<size_t>(row) * bt;
#pragma unroll
            for (int t = 0; t < BT; ++t)
              if (t < nb) dst[t] = val[t];
          }
        }
        carry_row = __shfl_sync(kFull, open ? row : -1, 31);
#pragma unroll
        for (int t = 0; t < BT; ++t) carry[t] = __shfl_sync(kFull, val[t], 31);
      }
    }
    __syncthreads();
    // Boundary rows, in chunk order: one thread per batch column.
    if (threadIdx.x < nb) {
      const int t = threadIdx.x;
      const int nq = min(kWarps, c_hi - base);
      for (int q = 0; q < nq; ++q) {
        for (int s = 0; s < 2; ++s) {
          const int r = brow[q * 2 + s];
          if (r >= 0) {
            A* dst = tile + static_cast<size_t>(r) * bt + t;
            *dst = repro::add(*dst, bsum[(q * 2 + s) * BT + t]);
          }
        }
      }
    }
    __syncthreads();
  }

  const int row0 = w * span;
  const int nrows = max(0, min(span, out_rows - row0));
  for (int i = threadIdx.x; i < nrows * nb; i += blockDim.x) {
    const int r = i / nb;
    const int t = i - r * nb;
    y[static_cast<size_t>(row0 + r) * B + b0 + t] = tile[static_cast<size_t>(r) * bt + t];
  }
}

template <typename V, int BT>
int launch(const int* window_start, const int* count, const int* rowind,
           const int* colind, const void* values, const void* x, void* y,
           const int* x_offset, int n_windows, int E, int span, int out_rows,
           int n_cols, int B, int bt, int n_parts, int n_chunks,
           cudaStream_t stream) {
  using A = typename repro::Acc<V>::type;
  const size_t smem = sizeof(A) * (static_cast<size_t>(span) * bt + kWarps * 2 * BT) +
                      sizeof(int) * kWarps * 2;
  auto kernel = coo_window_kernel<V, BT>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(n_windows, (B + bt - 1) / bt, n_parts);
  kernel<<<grid, kWarps * 32, smem, stream>>>(
      window_start, count, rowind, colind, static_cast<const V*>(values),
      static_cast<const V*>(x), static_cast<typename repro::Acc<V>::type*>(y),
      x_offset, E, span, out_rows, n_cols, B, bt, n_chunks);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// y (n_parts, out_rows, B) in the accumulation dtype = plan @ x, part p
// reading x rows [x_offset[p], x_offset[p] + n_cols) (x_offset may be null:
// every part reads x from row 0), x row-major with B columns.  Returns the
// cudaError_t of the launch (0 on success).
extern "C" int repro_coo_spmv(const int* window_start, const int* count,
                              const int* rowind, const int* colind,
                              const void* values, const void* x, void* y,
                              const int* x_offset, int n_windows, int E,
                              int span, int out_rows, int n_cols, int B, int bt,
                              int n_parts, int n_chunks, int dtype, void* stream) {
  if (n_windows < 1 || B < 1 || bt < 1 || bt > 32 || n_cols < 1 || n_parts < 1 ||
      n_parts > 65535 || n_chunks < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define REPRO_COO_ARGS                                                            \
  window_start, count, rowind, colind, values, x, y, x_offset, n_windows, E, span, \
      out_rows, n_cols, B, bt, n_parts, n_chunks, s
  REPRO_DISPATCH_DTYPE(dtype, {
    if (bt == 1) return launch<V, 1>(REPRO_COO_ARGS);
    if (bt <= 8) return launch<V, 8>(REPRO_COO_ARGS);
    return launch<V, 32>(REPRO_COO_ARGS);
  });
#undef REPRO_COO_ARGS
  return 0;
}
