// qap_count: one pass of the planner's stack-machine bytecode over every
// row of the (N, 13) int32 planes; counter k gets the number of VALID rows
// on which the k-th counter expression holds.
//
// Replaces the TPU kernel src/repro/kernels/qap_count/kernel.py
// (fused_count_kernel, its body _kernel and the unrolled stack machine
// _eval_block). That kernel unrolls a static program at trace time and
// carries a (1, 128) accumulator across its sequential grid. Here blocks
// run in parallel and in no order: each keeps its partial counts in shared
// memory and adds them into the int64 output with one atomicAdd per
// counter at its end. Integer sums give the same result in any order, so
// the counts are exact and the same on every run.
//
// What bounds it on an H100: the bytes. Each row is 52 bytes and every
// row is read once; a program does a few integer operations per row and
// instruction, far below the card's rate. So the design (1) reads each
// tile once, 16 bytes per thread, fully coalesced, into shared memory,
// (2) decodes each instruction once for ROWS_PER_THREAD rows, and
// (3) reduces an EMIT with a warp ballot + popcount and one shared atomic
// per warp, so no per-row atomics reach device memory. Measured on the
// card (PERF.md), this simple version is still held back by the work of
// interpreting the program, not by the bytes: a tile's load and its
// evaluation do not overlap within a block, and each instruction is
// decoded from shared memory for every 4 rows.
//
// C interface (bound with ctypes); returns a cudaError_t, 0 on success.
#include "scan_common.cuh"

using namespace scan;

__global__ void __launch_bounds__(THREADS)
qap_count_kernel(const int* __restrict__ planes, long long n_rows,
                 const int* __restrict__ program, int n_instr,
                 int n_counters, unsigned long long* __restrict__ counts) {
  extern __shared__ __align__(16) int smem[];
  __shared__ unsigned long long s_counts[MAX_COUNTERS];
  int* tile = smem;
  int* prog = smem + TILE_WORDS;

  for (int i = threadIdx.x; i < 3 * n_instr; i += THREADS) prog[i] = program[i];
  for (int i = threadIdx.x; i < n_counters; i += THREADS) s_counts[i] = 0;

  const long long n_tiles = (n_rows + TILE_ROWS - 1) / TILE_ROWS;
  for (long long t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    __syncthreads();  // previous tile fully consumed (and prog staged)
    load_tile(tile, planes, t * TILE_ROWS, n_rows);
    __syncthreads();
    run_program(prog, n_instr, tile, s_counts);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < n_counters; i += THREADS)
    if (s_counts[i]) atomicAdd(&counts[i], s_counts[i]);
}

extern "C" int qap_count(const int* planes, long long n_rows,
                         const int* program, int n_instr, int n_counters,
                         unsigned long long* counts, void* stream) {
  if (n_rows <= 0) return 0;
  const size_t smem =
      sizeof(int) * ((size_t)TILE_WORDS + program_words(n_instr));
  const long long n_tiles = (n_rows + TILE_ROWS - 1) / TILE_ROWS;
  cudaError_t err;
  const int blocks = grid_blocks((const void*)qap_count_kernel, smem,
                                 n_tiles, &err);
  if (err != cudaSuccess) return (int)err;
  qap_count_kernel<<<blocks, THREADS, smem, (cudaStream_t)stream>>>(
      planes, n_rows, program, n_instr, n_counters, counts);
  return (int)cudaGetLastError();
}
