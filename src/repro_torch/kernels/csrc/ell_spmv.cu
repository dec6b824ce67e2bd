// ELL (padded-row) SpMV and SpMM for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/ell_spmv.py:ell_spmv_pallas.
// Every row is padded to K slots: colind and values are (rows, K) row-major,
// row_nnz (rows,) says how many slots of a row are real.  The TPU kernel
// took a (64-row, 128-lane) tile per grid step, gathered x for the whole
// tile, multiplied, masked the slots k >= row_nnz and summed each row.
//
// Design.  One thread per output element (row r, batch column b): it loops
// over the row's real slots k < min(row_nnz[r], K), gathers x at the slot's
// column clipped to [0, n_cols) (the reference's take(mode="clip")),
// multiplies in the accumulation dtype and adds in slot order, then writes
// y once.  The padded slots are never read.  A CTA holds about 256 threads:
// bt batch columns (fastest, so an SpMM reads x rows coalesced) times as
// many rows as fit.  No shared memory and no atomics; each sum runs in slot
// order whatever the batch tile, so the result does not depend on it.
//
// Bound.  Memory: every slot moves its column and value (4 + value bytes),
// row_nnz, x and y move once.  The threads of a warp read 32 different
// rows, so each load instruction touches 32 cache lines; the lines are
// reused from L1 over the next slots of the same rows.  Reading the
// (rows, K) stream coalesced (a warp per row tile, slots across lanes) is
// later work.

#include "common.cuh"

namespace {

template <typename V>
__global__ void __launch_bounds__(1024)
ell_rows_kernel(const int* __restrict__ colind,
                const V* __restrict__ values,
                const int* __restrict__ row_nnz,
                const V* __restrict__ x,
                typename repro::Acc<V>::type* __restrict__ y,
                int rows, int K, int n_cols, int B, int bt, int rows_per_cta) {
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

}  // namespace

// y (rows, B) in the accumulation dtype = ELL(colind, values, row_nnz) @ x,
// x (n_cols, B) row-major.  Returns the cudaError_t of the launch (0 on
// success).
extern "C" int repro_ell_spmv(const int* colind, const void* values,
                              const int* row_nnz, const void* x, void* y,
                              int rows, int K, int n_cols, int B, int bt,
                              int dtype, void* stream) {
  if (rows < 1 || K < 1 || n_cols < 1 || B < 1 || bt < 1 || bt > 1024)
    return static_cast<int>(cudaErrorInvalidValue);
  const int rows_per_cta = max(1, 256 / bt);
  const dim3 grid((rows + rows_per_cta - 1) / rows_per_cta, (B + bt - 1) / bt);
  const int threads = rows_per_cta * bt;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  REPRO_DISPATCH_DTYPE(dtype, {
    ell_rows_kernel<V><<<grid, threads, 0, s>>>(
        colind, static_cast<const V*>(values), row_nnz, static_cast<const V*>(x),
        static_cast<typename repro::Acc<V>::type*>(y), rows, K, n_cols, B, bt,
        rows_per_cta);
  });
  return static_cast<int>(cudaGetLastError());
}
