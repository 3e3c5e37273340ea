// scan_spec: the block structure of the plan-specialized scan kernel.
//
// One source per plan: repro_torch/kernels/scan_codegen.py prints the plan
// as the straight-line device function spec_row (the distinct leaves, the
// AND/OR/NOT nodes, one counter slot per EMIT, each sketch's hash chain),
// defines the SPEC_* constants below and includes this file; NVRTC
// compiles the result for sm_90a at first use (kernels/_build.py). With no
// sketches the kernel is qap_count, with S >= 1 sketches fused_scan.
//
// Replaces the TPU kernels src/repro/kernels/qap_count/kernel.py
// (fused_count_kernel and its unrolled stack machine _eval_block) and
// src/repro/kernels/fused_scan/kernel.py (fused_scan_kernel, _kernel and
// _sketch_update). Those take the program as a static argument and unroll
// it at trace time; so does this kernel, at generation time. They carry
// accumulators across a sequential grid and fold registers with a one-hot
// scatter-max, because the TPU has no scatter; here persistent blocks run
// in parallel, each keeps its counters in registers and its register
// banks in shared memory (or in the global output when they do not fit),
// and folds them into the outputs with one global atomic per counter and
// per register at its end. Integer sums and maxima are order-independent,
// so the results are bit-identical to the plain versions on every run.
//
// What bounds it on an H100: the bytes, 52 a row read once (4.26 GB at
// 81,980,472 rows, at least 1.27 ms at 3.35 TB/s), if the integer work of
// a row stays within the issue slots the card has for it in that time
// (about 260 integer operations a row at 64 INT32 lanes an SM). So:
//   * no interpretation: the plan is straight-line code, every counter a
//     register of its thread, incremented by (bit & valid) per row; no
//     ballots and no shared atomics in the loop;
//   * the bytes stream: a ring of SPEC_STAGES tile buffers in shared
//     memory, each filled by one bulk copy (cp.async.bulk with an mbarrier
//     counting its bytes) issued by one thread, SPEC_STAGES - 1 tiles ahead
//     of the tile being evaluated;
//   * a thread reads from a staged row only the planes the plan needs; the
//     row stride is 13 words, odd, so the 32 rows of a warp hit 32 banks.
// A base that is not 16-byte aligned cannot be bulk-copied: the block then
// stages each tile word by word. The rows after the last full tile are
// staged word by word too, every word of the buffer written by exactly one
// thread (a zero past the end), by the block that would take the next tile.
#pragma once

#include "scan_common.cuh"

#ifndef SPEC_THREADS
#error "include scan_spec.cuh from a source printed by scan_codegen.py"
#endif

namespace scan {

constexpr int S_THREADS = SPEC_THREADS;
constexpr int S_WARPS = SPEC_THREADS / 32;
constexpr int S_TILE_ROWS = SPEC_TILE_ROWS;
constexpr int S_ROWS_PER_THREAD = SPEC_TILE_ROWS / SPEC_THREADS;
constexpr int S_TILE_WORDS = SPEC_TILE_ROWS * N_PLANES;
constexpr unsigned S_TILE_BYTES = 4u * S_TILE_WORDS;
constexpr int S_STAGES = SPEC_STAGES;
constexpr int S_COUNTER_SLOTS = SPEC_N_COUNTERS > 0 ? SPEC_N_COUNTERS : 1;
constexpr int S_BANK_WORDS = SPEC_N_SKETCHES << SPEC_P;
static_assert(S_TILE_ROWS % S_THREADS == 0, "whole rows a thread");
static_assert(S_TILE_BYTES % 16 == 0, "bulk copies move 16-byte words");

// The plan, printed by scan_codegen.py after this file: adds the counter
// bits of one staged row to cnt and folds it into the register banks.
__device__ __forceinline__ void spec_row(const int* __restrict__ row,
                                         unsigned* __restrict__ cnt,
                                         int* __restrict__ banks);

// --- the ring's barriers and bulk copies (PTX, sm_90) -----------------------

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  unsigned a;
  asm volatile("{ .reg .u64 t; cvta.to.shared.u64 t, %1; cvt.u32.u64 %0, t; }"
               : "=r"(a) : "l"(p));
  return a;
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
               :: "r"(smem_addr(bar)), "r"(count) : "memory");
}

// Fill `dst` with `bytes` from global `src`; the barrier's phase completes
// when they have landed.
__device__ __forceinline__ void bulk_load(int* dst, const int* src,
                                          unsigned bytes, uint64_t* bar) {
  const unsigned b = smem_addr(bar);
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(b), "r"(bytes) : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];"
      :: "r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(b) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  const unsigned b = smem_addr(bar);
  unsigned done;
  do {
    asm volatile(
        "{ .reg .pred p; mbarrier.try_wait.parity.shared::cta.b64 p, [%1], "
        "%2; selp.u32 %0, 1, 0, p; }"
        : "=r"(done) : "r"(b), "r"(parity) : "memory");
  } while (!done);
}

// --- tiles --------------------------------------------------------------------

// Rows [row0, min(row0 + S_TILE_ROWS, n_rows)) into `tile` word by word,
// zeros past the end: every word has exactly one writer. Zero rows carry
// no VALID bit and no s_flags, so they count and fold nothing.
__device__ __forceinline__ void load_words(int* __restrict__ tile,
                                           const int* __restrict__ planes,
                                           long long row0, long long n_rows) {
  const long long left = (n_rows - row0) * N_PLANES;
  const int words = left < S_TILE_WORDS ? (int)left : S_TILE_WORDS;
  const int* src = planes + row0 * N_PLANES;
  for (int i = threadIdx.x; i < S_TILE_WORDS; i += S_THREADS)
    tile[i] = i < words ? __ldg(src + i) : 0;
}

// This thread's rows of a staged tile: tid, tid + S_THREADS, ...
__device__ __forceinline__ void eval_tile(const int* tile, unsigned* cnt,
                                          int* banks) {
#pragma unroll
  for (int r = 0; r < S_ROWS_PER_THREAD; ++r)
    spec_row(tile + (r * S_THREADS + threadIdx.x) * N_PLANES, cnt, banks);
}

// planes: (n_rows, 13) int32; counts: zeroed (SPEC_N_COUNTERS,) int64;
// regs: zeroed (SPEC_N_SKETCHES, 2^SPEC_P) int32 (unused without sketches).
extern "C" __global__ void __launch_bounds__(S_THREADS)
scan_spec(const int* __restrict__ planes, long long n_rows,
          unsigned long long* __restrict__ counts, int* __restrict__ regs) {
  extern __shared__ __align__(128) int smem[];  // [stages | shared banks]
  __shared__ __align__(8) uint64_t full[S_STAGES];
  __shared__ unsigned warp_counts[S_WARPS][S_COUNTER_SLOTS];
  int* banks = SPEC_SHARED_BANKS ? smem + S_STAGES * S_TILE_WORDS : regs;
  const int tid = threadIdx.x;

  if (SPEC_SHARED_BANKS)
    for (int i = tid; i < S_BANK_WORDS; i += S_THREADS) banks[i] = 0;
  if (tid == 0) {
    for (int s = 0; s < S_STAGES; ++s) mbar_init(&full[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  unsigned cnt[S_COUNTER_SLOTS];
#pragma unroll
  for (int k = 0; k < S_COUNTER_SLOTS; ++k) cnt[k] = 0;

  // this block's full tiles: blockIdx.x, blockIdx.x + gridDim.x, ...
  const long long n_full = n_rows / S_TILE_ROWS;
  const long long mine =
      blockIdx.x < n_full ? (n_full - 1 - blockIdx.x) / gridDim.x + 1 : 0;
  const int* first = planes + (long long)blockIdx.x * S_TILE_WORDS;
  const long long step = (long long)gridDim.x * S_TILE_WORDS;

  if ((reinterpret_cast<unsigned long long>(planes) & 15) == 0) {
    if (tid == 0)
      for (int j = 0; j < S_STAGES - 1 && j < mine; ++j)
        bulk_load(smem + j * S_TILE_WORDS, first + j * step, S_TILE_BYTES,
                  &full[j]);
    int stage = 0;
    unsigned parity = 0;
    for (long long k = 0; k < mine; ++k) {
      // the buffer of tile k - 1 is free once every thread is past it;
      // it takes tile k + S_STAGES - 1
      if (k > 0) __syncthreads();
      const long long next = k + S_STAGES - 1;
      if (tid == 0 && next < mine) {
        const int s = (int)(next % S_STAGES);
        asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
        bulk_load(smem + s * S_TILE_WORDS, first + next * step, S_TILE_BYTES,
                  &full[s]);
      }
      mbar_wait(&full[stage], parity);
      eval_tile(smem + stage * S_TILE_WORDS, cnt, banks);
      if (++stage == S_STAGES) {
        stage = 0;
        parity ^= 1;
      }
    }
  } else {
    for (long long k = 0; k < mine; ++k) {
      __syncthreads();
      load_words(smem, planes, (blockIdx.x + k * gridDim.x) * S_TILE_ROWS,
                 n_rows);
      __syncthreads();
      eval_tile(smem, cnt, banks);
    }
  }
  // the ragged tail, on the block whose turn the next tile would be
  if (n_rows > n_full * S_TILE_ROWS && blockIdx.x == n_full % gridDim.x) {
    __syncthreads();
    load_words(smem, planes, n_full * S_TILE_ROWS, n_rows);
    __syncthreads();
    eval_tile(smem, cnt, banks);
  }

  // counters: a warp's sums by shuffles, the block's in shared memory,
  // then one global atomic per counter
  const int lane = tid & 31, warp = tid >> 5;
#pragma unroll
  for (int k = 0; k < S_COUNTER_SLOTS; ++k) {
    unsigned v = cnt[k];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xFFFFFFFFu, v, o);
    if (lane == 0) warp_counts[warp][k] = v;
  }
  __syncthreads();
  for (int k = tid; k < SPEC_N_COUNTERS; k += S_THREADS) {
    unsigned long long sum = 0;
#pragma unroll
    for (int w = 0; w < S_WARPS; ++w) sum += warp_counts[w][k];
    if (sum) atomicAdd(&counts[k], sum);
  }
  if (SPEC_SHARED_BANKS)
    for (int i = tid; i < S_BANK_WORDS; i += S_THREADS)
      if (banks[i]) raise_to(regs + i, banks[i], false);
}

}  // namespace scan
