// fused_scan: in ONE pass over the (N, 13) int32 planes, the qap_count
// counters and, for every HyperLogLog sketch of the plan, its bank of 2^p
// int32 registers.
//
// Replaces the TPU kernel src/repro/kernels/fused_scan/kernel.py
// (fused_scan_kernel, its body _kernel and _sketch_update). That kernel
// folds a block into the registers with a dense one-hot (rows, 2^p)
// scatter-max sized to a VMEM budget, because the TPU's vector unit has no
// scatter. Hopper has one: each block keeps a register bank per sketch in
// shared memory, updates it with shared atomicMax, and folds it into the
// zeroed (S, 2^p) output with global atomicMax at its end. When the banks
// do not fit the shared memory the kernel sets aside for them
// (SHARED_BANK_BYTES), every update goes straight to the global bank. Max
// and integer sums are order-independent, so counters and registers are
// bit-identical to the plain version whatever order blocks run in.
//
// The hash, rank and register update (scan_common.cuh) are the ones
// hll_fold.cu uses, so both kernels give the same registers.
//
// What bounds it on an H100: the bytes, as for qap_count (52 bytes a
// row, read once). The hashes cost some 10 integer operations per column,
// and most ranks are small, so an update is first checked against the
// register it would raise and the atomic is skipped when it would not.
// Measured on the card (PERF.md), this simple version is held back by
// that integer work and the bytecode interpretation, not by the bytes.
//
// C interface (bound with ctypes); returns a cudaError_t, 0 on success.
#include "scan_common.cuh"

using namespace scan;

constexpr int MAX_SKETCHES = 16;

struct SketchSpec {
  int n_sketches;
  int n_cols[MAX_SKETCHES];
  int cols[MAX_SKETCHES][N_PLANES];
};

__global__ void __launch_bounds__(THREADS)
fused_scan_kernel(const int* __restrict__ planes, long long n_rows,
                  const int* __restrict__ program, int n_instr,
                  int n_counters, unsigned long long* __restrict__ counts,
                  const SketchSpec spec, int p, bool shared_banks,
                  int* __restrict__ regs) {
  extern __shared__ __align__(16) int smem[];
  __shared__ unsigned long long s_counts[MAX_COUNTERS];
  __shared__ int s_cols[MAX_SKETCHES][N_PLANES];  // addressable copy of spec
  int* tile = smem;
  int* prog = smem + TILE_WORDS;
  const int bank_words = spec.n_sketches << p;
  int* banks = shared_banks ? prog + program_words(n_instr) : regs;

  for (int i = threadIdx.x; i < 3 * n_instr; i += THREADS) prog[i] = program[i];
  for (int i = threadIdx.x; i < MAX_SKETCHES * N_PLANES; i += THREADS)
    s_cols[i / N_PLANES][i % N_PLANES] = spec.cols[i / N_PLANES][i % N_PLANES];
  for (int i = threadIdx.x; i < n_counters; i += THREADS) s_counts[i] = 0;
  if (shared_banks)
    for (int i = threadIdx.x; i < bank_words; i += THREADS) banks[i] = 0;

  const long long n_tiles = (n_rows + TILE_ROWS - 1) / TILE_ROWS;
  for (long long t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    __syncthreads();
    load_tile(tile, planes, t * TILE_ROWS, n_rows);
    __syncthreads();
    run_program(prog, n_instr, tile, s_counts);

#pragma unroll
    for (int r = 0; r < ROWS_PER_THREAD; ++r) {
      const int* row = row_ptr(tile, r);
      if (row[VALID_PLANE] == 0) continue;  // padding row: rank 0
      for (int s = 0; s < spec.n_sketches; ++s) {
        const uint32_t h = hash_row(row, s_cols[s], spec.n_cols[s]);
        raise_to(banks + (s << p) + (int)(h >> (32 - p)), hll_rank(h, p),
                 shared_banks);
      }
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < n_counters; i += THREADS)
    if (s_counts[i]) atomicAdd(&counts[i], s_counts[i]);
  if (shared_banks)
    for (int i = threadIdx.x; i < bank_words; i += THREADS)
      if (banks[i]) raise_to(regs + i, banks[i], false);
}

// sketch_cols: host array of n_sketches rows of N_PLANES + 1 ints, each
// row (n_cols, col_0, ..., col_{n_cols-1}, unused...).
extern "C" int fused_scan(const int* planes, long long n_rows,
                          const int* program, int n_instr, int n_counters,
                          unsigned long long* counts, const int* sketch_cols,
                          int n_sketches, int p, int* regs, void* stream) {
  if (n_rows <= 0) return 0;
  if (n_sketches > MAX_SKETCHES) return (int)cudaErrorInvalidValue;
  SketchSpec spec = {};
  spec.n_sketches = n_sketches;
  for (int s = 0; s < n_sketches; ++s) {
    const int* row = sketch_cols + s * (N_PLANES + 1);
    spec.n_cols[s] = row[0];
    for (int j = 0; j < row[0]; ++j) spec.cols[s][j] = row[1 + j];
  }
  const size_t bank_bytes = sizeof(int) * ((size_t)n_sketches << p);
  const bool shared_banks = bank_bytes <= (size_t)SHARED_BANK_BYTES;
  const size_t smem =
      sizeof(int) * ((size_t)TILE_WORDS + program_words(n_instr)) +
      (shared_banks ? bank_bytes : 0);
  const long long n_tiles = (n_rows + TILE_ROWS - 1) / TILE_ROWS;
  cudaError_t err;
  const int blocks = grid_blocks((const void*)fused_scan_kernel, smem,
                                 n_tiles, &err);
  if (err != cudaSuccess) return (int)err;
  fused_scan_kernel<<<blocks, THREADS, smem, (cudaStream_t)stream>>>(
      planes, n_rows, program, n_instr, n_counters, counts, spec, p,
      shared_banks, regs);
  return (int)cudaGetLastError();
}
