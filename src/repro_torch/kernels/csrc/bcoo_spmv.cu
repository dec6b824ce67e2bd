// Block-sparse (BCOO / BCSR) SpMV and SpMM for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/bcsr_spmv.py:bcoo_spmv_pallas.
// The TPU kernel took one grid step per nonzero (r, c) block and carried the
// block-row's sum from step to step in VMEM; blocks run in no order here,
// so the sequential grid axis becomes a loop inside the thread.
//
// Design.  One thread per output element (row i of block-row br, batch
// column b): it walks its block-row's blocks through the block-row pointer
// array (BCSR's browptr, or one built once from BCOO's browind), takes each
// block's c-long dot product with x in order, adds it to a register sum and
// writes y once — zero for an empty block-row.  A CTA holds an r x bt thread
// tile for each of several block-rows (about 256 threads), batch columns
// fastest, so that an SpMM reads x rows coalesced and the threads of one
// block row share each value by broadcast.  No atomics and no shared
// memory; sums run in a fixed order independent of the batch tile.
//
// Bound.  Memory: every block moves its r*c values and one column index, x
// and y move once.  Each block is read once (its r rows by the r threads
// of a column, through L1), sums stay in registers and y is written once;
// the arithmetic (2 flops per 4-byte value) is far below the card's rate,
// so tensor-core mma/wgmma is left for a later change.
//
// Part axis.  As in coo_spmv.cu, blockIdx.z is the part of a partitioned
// matrix: part p walks its own block-row pointer (n_brows + 1 entries per
// part) over its own cap blocks, writes its own n_brows * r x B slice of y
// and reads x from its own window x[x_offset[p] :][: n_cols].  With one part
// and no x_offset the kernel is the single-device kernel, to the bit.

#include "common.cuh"

namespace {

template <typename V>
__global__ void __launch_bounds__(1024)
bcoo_rows_kernel(const int* __restrict__ browptr,
                 const int* __restrict__ bcolind,
                 const V* __restrict__ bvalues,
                 const V* __restrict__ x,
                 typename repro::Acc<V>::type* __restrict__ y,
                 const int* __restrict__ x_offset,
                 int n_brows, int r, int c, int n_cols, int B, int bt,
                 int brows_per_cta, int cap) {
  using A = typename repro::Acc<V>::type;
  const int part = blockIdx.z;
  browptr += static_cast<size_t>(part) * (n_brows + 1);
  bcolind += static_cast<size_t>(part) * cap;
  bvalues += static_cast<size_t>(part) * cap * r * c;
  y += static_cast<size_t>(part) * n_brows * r * B;
  if (x_offset != nullptr) x += static_cast<size_t>(x_offset[part]) * B;

  const int t = threadIdx.x % bt;
  const int i = (threadIdx.x / bt) % r;
  const int local = threadIdx.x / (bt * r);
  const int br = blockIdx.x * brows_per_cta + local;
  const int b = blockIdx.y * bt + t;
  if (local >= brows_per_cta || br >= n_brows || b >= B) return;
  const int n_bcols = (n_cols + c - 1) / c;

  A acc = A(0);
  const int k_hi = browptr[br + 1];
  for (int k = browptr[br]; k < k_hi; ++k) {
    const int bc = min(bcolind[k], n_bcols - 1);
    const V* a = bvalues + (static_cast<size_t>(k) * r + i) * c;
    const int col0 = bc * c;
    const int kc = min(c, n_cols - col0);  // x is zero past n_cols
    const V* xp = x + static_cast<size_t>(col0) * B + b;
    A s = A(0);
    for (int kk = 0; kk < kc; ++kk)
      s = repro::add(s, repro::mul(repro::to_acc(a[kk]),
                                   repro::to_acc(xp[static_cast<size_t>(kk) * B])));
    acc = repro::add(acc, s);
  }
  y[(static_cast<size_t>(br) * r + i) * B + b] = acc;
}

}  // namespace

// y (n_parts, n_brows * r, B) in the accumulation dtype = blocks @ x, part p
// reading x rows [x_offset[p], x_offset[p] + n_cols) (x_offset may be null:
// every part reads x from row 0), x row-major with B columns.  Returns the
// cudaError_t of the launch (0 on success).
extern "C" int repro_bcoo_spmv(const int* browptr, const int* bcolind,
                               const void* bvalues, const void* x, void* y,
                               const int* x_offset, int n_brows, int r, int c,
                               int n_cols, int B, int bt, int n_parts, int cap,
                               int dtype, void* stream) {
  if (n_brows < 1 || r < 1 || c < 1 || n_cols < 1 || B < 1 || bt < 1 ||
      r * bt > 1024 || n_parts < 1 || n_parts > 65535 || cap < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int brows_per_cta = max(1, 256 / (r * bt));
  const dim3 grid((n_brows + brows_per_cta - 1) / brows_per_cta, (B + bt - 1) / bt,
                  n_parts);
  const int threads = brows_per_cta * r * bt;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  REPRO_DISPATCH_DTYPE(dtype, {
    bcoo_rows_kernel<V><<<grid, threads, 0, s>>>(
        browptr, bcolind, static_cast<const V*>(bvalues), static_cast<const V*>(x),
        static_cast<typename repro::Acc<V>::type*>(y), x_offset, n_brows, r, c,
        n_cols, B, bt, brows_per_cta, cap);
  });
  return static_cast<int>(cudaGetLastError());
}
