// hll_fold: one HyperLogLog sketch's bank of 2^p int32 registers, folded
// over every row of the (N, 13) int32 planes in one pass.
//
// Replaces the TPU kernel src/repro/kernels/hll/kernel.py (hll_fold_kernel
// and its body _kernel). That kernel folds a block of rows with a dense
// one-hot (rows, 2^p) scatter-max, because the TPU's vector unit has no
// scatter, and carries the registers across its sequential grid. Here
// blocks run in parallel and in no order: each keeps a bank of 2^p
// registers in shared memory, raises it with shared atomicMax, and folds
// it into the zeroed global (2^p,) output with global atomicMax at its end.
// A bank larger than SHARED_BANK_BYTES (p > 14) is raised in place in the
// global output instead. Max is order-independent, so the registers are
// bit-identical to the plain version whatever order blocks run in. The
// hash, rank and update (scan_common.cuh) are the ones the
// plan-specialized scan kernel (scan_spec.cuh) uses.
//
// Reading the rows: a thread reads the few words of its row it needs (the
// sketch's columns and s_flags) straight from global memory, one row per
// thread in a grid-stride loop. Unlike the scan kernel it stages no tile:
// it needs a few words of a row, not the whole row, and without a staging
// barrier the loads of every warp on an SM overlap. The words a sketch
// reads lie within one or two 32-byte sectors of a 52-byte row, so the
// traffic from memory stays about one read of the planes.
//
// What bounds it on an H100: the bytes, 52 a row read once (4.26 GB at
// 81,980,472 rows, at least 1.27 ms at 3.35 TB/s). The operations are far
// below that: 11 a column and 14 a sketch, 47 a row for three columns
// (0.06 ms at 67 TOP/s). Most ranks are 1-3, so an update is checked
// against the register it would raise and the atomic skipped when it
// would not.
//
// Launched by kernels/hll/ops.py, which checks the arguments and chooses
// the shared memory, the bank's place and the grid.
#include "scan_common.cuh"

using namespace scan;

constexpr int THREADS = 128;

struct Columns {
  int n;
  int c[N_PLANES];
};

extern "C" __global__ void __launch_bounds__(THREADS)
hll_fold_kernel(const int* __restrict__ planes, long long n_rows,
                const Columns cols, int p, bool shared_bank,
                int* __restrict__ regs) {
  extern __shared__ __align__(16) int smem[];
  __shared__ int s_cols[N_PLANES];  // addressable copy of cols.c
  int* bank = shared_bank ? smem : regs;
  const int m = 1 << p;

  if (threadIdx.x < N_PLANES) s_cols[threadIdx.x] = cols.c[threadIdx.x];
  if (shared_bank)
    for (int i = threadIdx.x; i < m; i += THREADS) bank[i] = 0;
  __syncthreads();

  const long long stride = (long long)gridDim.x * THREADS;
  for (long long r = (long long)blockIdx.x * THREADS + threadIdx.x;
       r < n_rows; r += stride) {
    const int* row = planes + r * N_PLANES;
    const int flags = row[VALID_PLANE];
    const uint32_t h = hash_row(row, s_cols, cols.n);
    if (flags == 0) continue;  // padding row: rank 0
    raise_to(bank + (int)(h >> (32 - p)), hll_rank(h, p), shared_bank);
  }
  if (shared_bank) {
    __syncthreads();
    for (int i = threadIdx.x; i < m; i += THREADS)
      if (bank[i]) raise_to(regs + i, bank[i], false);
  }
}
